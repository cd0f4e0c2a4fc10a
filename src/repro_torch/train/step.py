# Port of src/repro/train/step.py:24-130 in torch: ParallelConfig,
# TrainState, init_train_state, sharding_rules, loss_fn and
# make_train_step, on one device and on a (data, model) mesh, with the
# grad-compress branch.  make_prefill_step and make_serve_step, and the
# Megatron split of the compute that sharding_rules names, are ROADMAP
# item 16c.
"""The training step: forward, backward and AdamW, on one device or a mesh.

``make_train_step`` has two forms, told apart by its second argument:

  make_train_step(cfg, pcfg, ocfg=None)
      one device: ``step_fn(state, batch) -> (state, metrics)``;
  make_train_step(cfg, mesh, pcfg, ocfg=None)
      a :class:`~repro_torch.launch.mesh.Mesh`: the reference's
      ``(step_fn, compile_step, state_shardings)``.  ``state_shardings``
      lays out params, moments and error feedback by ``param_spec`` and
      ``count``/``step`` replicated; ``compile_step(state_shapes,
      batch_shapes)`` returns the step over a state laid out so
      (``shardings.shard``) and a global batch; ``step_fn`` steps a full
      state (it lays it out, steps and gathers it back).

The mesh step is DP x FSDP over the mesh's hop rings.  The batch is split
by ``batch_specs`` over ("pod", "data"), or over every axis when
``tensor_parallel=False``.  Each stored slice is all-gathered once a step
for all local devices (``shardings.gather``, under autograd); each local
device runs ``loss_fn`` on its batch slice with its gathered copy, its
loss divided by the number of distinct batch slices; one backward runs
over all of them, the gather's backward reduce-scattering over the batch
axes.  AdamW updates each slice: the clip's norm and grad-compress's scale
are reduced over each leaf's split axes.  In this slice the ``model`` axis
shards storage only: its devices compute the same batch slice whole, as
one device would; the Megatron split of that compute (``sharding_rules``'
heads/ff/vocab) is item 16c and changes no number.

The forward is the model's cacheless ``lm.forward``; on the card its
attention runs K3's prefill kernel under autograd (K3e,
``kernels/flash_attention.py::train_attention``), once a local device.  A
step returns a new state and leaves its input as it was, as the
reference's (undonated) step does, so a caller may step one state twice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lisa import compression as COMP
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import shardings as SH
from repro_torch.train.shardings import P, NamedSharding


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


def sharding_rules(pcfg: ParallelConfig) -> Dict[str, Any]:
    rules: Dict[str, Any] = {}
    if pcfg.sequence_parallel:
        rules["seq_sp"] = "model"
    if not pcfg.tensor_parallel:
        # pure DP x FSDP: batch over every mesh axis, no compute sharding of
        # heads/ff/vocab (weights stay fully sharded and are gathered on use;
        # EP stays on "model" — it is DP-compatible).
        rules.update(batch=("pod", "data", "model"), heads=None,
                     kv_heads=None, ff=None, vocab=None, inner=None)
    return rules


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


def make_train_step(cfg: ModelConfig, *args, **kw):
    """One device: ``make_train_step(cfg, pcfg, ocfg=None) -> step_fn``.
    A mesh: ``make_train_step(cfg, mesh, pcfg, ocfg=None) -> (step_fn,
    compile_step, state_shardings)`` (module docstring).  A ``mesh`` as
    the second argument selects the second form."""
    if args and isinstance(args[0], Mesh):
        return _mesh_train_step(cfg, *args, **kw)
    return _train_step(cfg, *args, **kw)


def _refuse_moe_groups(pcfg: ParallelConfig) -> None:
    if pcfg.moe_groups:
        raise NotImplementedError(
            "moe_groups shards the MoE dispatch over the model axis: ROADMAP "
            "item 16c (the port routes in the model's own groups)")


def _mesh_compressed(grads, err_fb, shardings, amax):
    """The int8 error-feedback re-quantisation of laid-out gradients, as
    ``COMP.compress`` does a whole one: ``amax(target, sharding)`` is each
    local device's largest |value| of the whole tensor, (n_local,)."""
    def q(g, e, sh):
        target = g.to(torch.float32) + e
        scale = torch.clamp(amax(target, sh), min=1e-12) / 127.0
        scale = scale.view((-1,) + (1,) * (target.dim() - 1))
        qv = torch.clamp(torch.round(target / scale), -127,
                         127).to(torch.int8)
        return (COMP.decompress(qv, scale).to(g.dtype),
                target - qv.to(torch.float32) * scale)
    pairs = adamw.tree_map(q, grads, err_fb, shardings)
    return (adamw.tree_map(lambda t: t[0], pairs),
            adamw.tree_map(lambda t: t[1], pairs))


def _train_step(cfg: ModelConfig, pcfg: ParallelConfig,
                ocfg: Optional[adamw.OptConfig] = None):
    """The single-device ``step_fn(state, batch) -> (state, metrics)``."""
    ocfg = ocfg or adamw.OptConfig()
    _refuse_moe_groups(pcfg)

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


_METRICS = ("loss", "ce", "aux", "zloss")


def _mesh_train_step(cfg: ModelConfig, mesh: Mesh, pcfg: ParallelConfig,
                     ocfg: Optional[adamw.OptConfig] = None):
    ocfg = ocfg or adamw.OptConfig()
    _refuse_moe_groups(pcfg)
    moe = "moe" in cfg.mlp_kinds()

    def state_shardings(state_shapes: TrainState) -> TrainState:
        ps = SH.tree_shardings(state_shapes.params, mesh, SH.param_spec,
                               fsdp=pcfg.fsdp)
        rep = NamedSharding(mesh, P())
        return TrainState(
            params=ps, opt=adamw.OptState(m=ps, v=ps, count=rep), step=rep,
            err_fb=None if state_shapes.err_fb is None else ps)

    def compile_step(state_shapes: TrainState, batch_shapes):
        ss = state_shardings(state_shapes)
        dp = ("pod", "data") if pcfg.tensor_parallel else \
            ("pod", "data", "model")
        bs = SH.batch_specs(mesh, batch_shapes, dp_axes=dp)
        split = dict(bs["tokens"].dims()).get(0, ())
        batch_axes = tuple(a for a in split if mesh.shape[a] > 1)
        n_slices = math.prod(mesh.shape[a] for a in batch_axes)
        if moe and n_slices > 1:
            raise NotImplementedError(
                f"{cfg.name} has MoE layers, whose token groups and aux loss "
                f"span the global batch; a mesh that splits the batch over "
                f"{n_slices} devices would route in other groups: ROADMAP "
                f"item 16c")
        want = SH.tree_map(lambda x, sh: (mesh.n_local,)
                           + sh.local_shape(x.shape), state_shapes, ss)
        return lambda state, batch: _mesh_step(
            cfg, pcfg, ocfg, mesh, ss, want, bs, batch_axes, n_slices,
            state, batch)

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        ss = state_shardings(state)
        new, metrics = compile_step(state, batch)(SH.shard(state, ss), batch)
        return SH.unshard(new, ss), metrics

    return step_fn, compile_step, state_shardings


def _check_laid_out(path, x: torch.Tensor, shape) -> None:
    if tuple(x.shape) != shape:
        raise ValueError(
            f"{SH._path_str(path)}: the step takes a state laid out by "
            f"state_shardings ({shape}: local devices on dim 0); got "
            f"{tuple(x.shape)} — lay it out with shardings.shard")


def _mesh_step(cfg, pcfg, ocfg, mesh, ss, want, bs, batch_axes, n_slices,
               state: TrainState, batch) -> Tuple[TrainState, Dict]:
    """One step of the mesh form over a laid-out ``state`` (module
    docstring)."""
    SH.tree_map(_check_laid_out, state, want, with_path=True)
    shards = SH.shard(batch, bs)
    ps = ss.params
    leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(),
                            state.params)
    with torch.enable_grad():
        copies = adamw.tree_map(
            lambda p, sh: SH.gather(p, sh, batch_axes).unbind(0), leaves, ps)
        total, mets = 0.0, []
        for i in range(mesh.n_local):
            loss, m = loss_fn(cfg, pcfg,
                              adamw.tree_map(lambda c: c[i], copies),
                              {k: v[i] for k, v in shards.items()})
            total = total + loss / n_slices
            mets.append(torch.stack([loss.detach()] + [
                m[k].detach().to(torch.float32) for k in _METRICS[1:]]))
        flat = adamw.tree_leaves(leaves)
        gs = torch.autograd.grad(total, flat, allow_unused=True)
    by_leaf = {id(p): g for p, g in zip(flat, gs)}
    grads = adamw.tree_map(lambda p: torch.zeros_like(p)
                           if by_leaf[id(p)] is None else by_leaf[id(p)],
                           leaves)
    # the global batch's means: each slice's, summed over the batch axes
    met = torch.stack(mets)
    for a in batch_axes:
        met = mesh.axis(a).psum(met)
    met = met / n_slices

    def reduce_over(x, sh, op):
        """``x`` (n_local,) reduced over the axes ``sh`` splits."""
        for a in sh.axes():
            if mesh.shape[a] > 1:
                x = getattr(mesh.axis(a), op)(x)
        return x

    if pcfg.grad_compress:
        # the reference's per-tensor scale is the largest |value| of the
        # whole gradient: each slice's, maxed over the leaf's split axes
        grads, err_fb = _mesh_compressed(
            grads, state.err_fb, ps, lambda t, sh: reduce_over(
                t.abs().reshape(t.shape[0], -1).amax(1), sh, "pmax"))
    else:
        err_fb = state.err_fb
    sq = adamw.tree_map(lambda g, sh: reduce_over(
        torch.sum(torch.square(g.to(torch.float32)).reshape(g.shape[0], -1),
                  1), sh, "psum"), grads, ps)
    gnorm = torch.sqrt(sum(adamw.tree_leaves(sq)))
    params, opt, om = adamw.update(ocfg, grads, state.opt, state.params,
                                   gnorm=gnorm, lead=1)
    metrics = {k: met[0, j] for j, k in enumerate(_METRICS)}
    metrics.update(grad_norm=om["grad_norm"][0], lr=om["lr"][0])
    return TrainState(params, opt, state.step + 1, err_fb), metrics
