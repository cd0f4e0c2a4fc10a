# Port of src/repro/train/step.py:24-130 in torch, on one device:
# ParallelConfig, TrainState, init_train_state, loss_fn and the step of
# make_train_step, with its grad-compress branch.  What needs a mesh —
# sharding_rules, make_train_step's compile_step/state_shardings halves,
# make_prefill_step and make_serve_step — is ROADMAP item 16.
"""The single-device training step: forward, backward and AdamW.

``make_train_step`` returns ``step_fn(state, batch) -> (state, metrics)``.
The forward is the model's cacheless ``lm.forward``; on the card its
attention runs K3's prefill kernel under autograd (K3e,
``kernels/flash_attention.py::train_attention``).  A step returns a new
state and leaves its input as it was, as the reference's (undonated) step
does, so a caller may step one state twice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lisa import compression as COMP
from repro_torch.models import lm
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    fsdp: bool = True
    tensor_parallel: bool = True      # False: pure DPxFSDP over all axes
    sequence_parallel: bool = False   # shard layer-boundary activations on S
    grad_compress: bool = False       # int8 error-feedback DP all-reduce
    moe_groups: int = 0
    aux_weight: float = 0.01
    z_weight: float = 1e-4


class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState
    step: torch.Tensor
    err_fb: Any                        # error-feedback residuals (or None)


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     pcfg: ParallelConfig, dtype=torch.float32,
                     device=None) -> TrainState:
    """Random params from ``generator`` (``lm.init_lm``) on ``device``
    (default: cuda, raising without a GPU), zero moments and step."""
    params = lm.init_lm(cfg, generator, dtype, device)
    return state_from_params(params, pcfg)


def state_from_params(params, pcfg: ParallelConfig) -> TrainState:
    """A step-0 :class:`TrainState` over given params (the reference's
    through ``weights.params_from_jax``, say)."""
    dev = adamw.tree_leaves(params)[0].device
    return TrainState(
        params=params, opt=adamw.init(params),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        err_fb=COMP.init_error(params) if pcfg.grad_compress else None)


def loss_fn(cfg: ModelConfig, pcfg: ParallelConfig, params, batch
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux, _ = lm.forward(
        cfg, params, batch["tokens"], positions=batch.get("positions"),
        enc_embeds=batch.get("enc_embeds"))
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    ce = (logz - tgt).mean()
    zloss = torch.square(logz).mean()
    loss = ce + pcfg.aux_weight * aux + pcfg.z_weight * zloss
    return loss, {"ce": ce, "aux": aux, "zloss": zloss}


def grads_of(cfg: ModelConfig, pcfg: ParallelConfig, params, batch
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict]:
    """``(loss, metrics, grads)`` of :func:`loss_fn` at ``params``: the
    reference's ``jax.value_and_grad(..., has_aux=True)``.  The grads are
    taken with respect to detached leaves, so ``params`` gain no grad."""
    leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, pcfg, leaves, batch)
        flat = adamw.tree_leaves(leaves)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
    by_leaf = {id(p): g for p, g in zip(flat, gs)}
    # a leaf the loss does not reach has a zero gradient, as under jax.grad
    grads = adamw.tree_map(lambda p: torch.zeros_like(p)
                           if by_leaf[id(p)] is None else by_leaf[id(p)],
                           leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig,
                    ocfg: Optional[adamw.OptConfig] = None):
    """The single-device ``step_fn(state, batch) -> (state, metrics)``."""
    ocfg = ocfg or adamw.OptConfig()
    if pcfg.moe_groups:
        raise NotImplementedError(
            "moe_groups shards the MoE dispatch over a mesh: ROADMAP item "
            "16 (one device routes in the model's own groups)")

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, metrics, grads = grads_of(cfg, pcfg, state.params, batch)
        if pcfg.grad_compress:
            # int8 error-feedback re-quantisation of the gradient (the
            # quantised payload is what a LISA ring would carry).
            def q(g, e):
                qv, s, ne = COMP.compress(g, e)
                return COMP.decompress(qv, s).to(g.dtype), ne
            pairs = adamw.tree_map(q, grads, state.err_fb)
            grads = adamw.tree_map(lambda t: t[0], pairs)
            err_fb = adamw.tree_map(lambda t: t[1], pairs)
        else:
            err_fb = state.err_fb
        params, opt, om = adamw.update(ocfg, grads, state.opt, state.params)
        metrics = dict(metrics, loss=loss, **om)
        return TrainState(params, opt, state.step + 1, err_fb), metrics

    return step_fn
