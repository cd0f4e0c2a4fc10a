# Port of src/repro/train/step.py in torch: ParallelConfig, TrainState,
# init_train_state, sharding_rules, loss_fn, make_train_step,
# _logits_sharding, make_prefill_step and make_serve_step, on one device
# and on a (data, model) mesh, with the grad-compress branch and the
# Megatron split of the compute that sharding_rules names.
"""The training step, and the prefill and decode steps over a mesh.

``make_train_step`` has two forms, told apart by its second argument:

  make_train_step(cfg, pcfg, ocfg=None, donate=True)
      one device: ``step_fn(state, batch) -> (state, metrics)``;
  make_train_step(cfg, mesh, pcfg, ocfg=None, donate=True)
      a :class:`~repro_torch.launch.mesh.Mesh`: the reference's
      ``(step_fn, compile_step, state_shardings)``.  ``state_shardings`` lays
      out params, moments and error feedback by ``param_spec`` and
      ``count``/``step`` replicated; ``compile_step(state_shapes,
      batch_shapes)`` returns the step over a state laid out so
      (``shardings.shard``) and a global batch; ``step_fn`` steps a full
      state (it lays it out, steps and gathers it back).

``make_prefill_step(cfg, mesh, pcfg)`` and ``make_serve_step(cfg, mesh,
pcfg)`` return the reference's ``(step_fn, compile_step)``:
``compile_step(param_shapes, cache_shapes, batch_shapes)`` (token shapes
for the serve step) returns a step over params laid out by ``param_spec``,
a cache laid out by ``cache_spec`` (``shard(cache, cs, stack_dim=1)``: each
layer's slices then fold into one batch without a copy) and a global
batch, whose logits come out laid out by :func:`_logits_sharding`; the
cache is written IN PLACE.  ``step_fn`` takes and returns full trees.

The mesh steps run the reference's compute split (``sharding_rules``,
``models/sharding.py``).  The batch is split by ``batch_specs`` over
("pod", "data"), or over every axis when ``tensor_parallel=False``; the
local devices of a stacked mesh fold into the batch, so one forward runs
for the whole stack (K3 launches once a layer).  With
``tensor_parallel`` the ``model`` axis splits the compute: heads, ``ff``,
vocab and experts over it (``shardings.compute_dim``), the row-parallel
outputs all-reduced over it (reduce-scattered on S with
``sequence_parallel``), the cross entropy over the vocab-split logits by a
``pmax`` and a ``psum``.  A leaf the compute uses split keeps its
``model`` slice and is all-gathered over its other axes only; any other
is gathered whole.  A stacked layer leaf is gathered one rep at a time,
inside the rep's function, which ``cfg.remat`` checkpoints: the backward
gathers each rep's params again and no rep's gathered copy is held
through it (ZeRO-3).  The gathers' backward reduce-scatters over the batch
axes, and over ``model`` for a leaf each device of a model group uses
whole (each holds a share of its gradient).  The loss is replicated over
``model`` and counts once: each device's loss is divided by the batch
slices and the model axis's size.  AdamW updates each slice: the clip's
norm and grad-compress's scale are reduced over each leaf's split axes.
Every layer kind splits: GQA, MLA (query heads), cross attention and the
encoder (heads), mamba (inner channels), rwkv (heads and ``ff``), dense
and MoE MLPs; a layer stays whole only where its axis does not divide the
model axis (the reference's fit rule).

``donate`` is the reference's keyword with the reference's default, True
(its ``compile_step`` jits with ``donate_argnums=(0,)``): the step writes
the new params, moments, ``count``, ``step`` and error feedback into the
state it was given (the laid-out one on a mesh) and returns that state,
so the old and new copies never coexist; its numbers are the undonated
step's, bit for bit.  With ``donate=False`` a step returns a new state and
leaves its input as it was, so a caller may step one state twice.  The
mesh form's ``step_fn`` lays its full state out (a copy) and steps that.

On the card the forward's attention runs K3's prefill kernel under
autograd (K3e, ``kernels/flash_attention.py::train_attention``), the
decode step K3's split-KV kernel.
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
from repro_torch.models import sharding as SHD
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
    """The reference's loss: cross entropy, the MoE aux loss and the
    z-loss.  In a sharding context (the mesh step) every value is (n_local,),
    each device's over its rows, and the cross entropy runs over the
    vocab-split logits (:func:`_vocab_ce`)."""
    logits, aux, _ = lm.forward(
        cfg, params, batch["tokens"], positions=batch.get("positions"),
        enc_embeds=batch.get("enc_embeds"), moe_groups=pcfg.moe_groups)
    logits = logits.to(torch.float32)
    if SHD.active():
        logz, tgt = _vocab_ce(cfg, logits, batch["labels"].long())
        n = SHD.n_local()

        def mean(t):
            return SHD.dev(t).reshape(n, -1).mean(1)
        ce, zloss = mean(logz - tgt), mean(torch.square(logz))
        aux = aux.expand(n) if aux.dim() == 0 else aux
    else:
        logz = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
        ce = (logz - tgt).mean()
        zloss = torch.square(logz).mean()
    loss = ce + pcfg.aux_weight * aux + pcfg.z_weight * zloss
    return loss, {"ce": ce, "aux": aux, "zloss": zloss}


def _vocab_ce(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logz, target logit)`` of folded logits, whole or split over the
    vocab: split, ``logsumexp`` by a ``pmax`` (no gradient: it cancels)
    and a ``psum`` of the shifted exponentials over the model axis, the
    target logit by a masked gather on the device that holds it and a
    ``psum``."""
    vl = logits.shape[-1]
    if vl == cfg.vocab_size:
        return (torch.logsumexp(logits, dim=-1),
                logits.gather(-1, labels[..., None])[..., 0])
    c = SHD.ctx()
    mx = c.model.pmax(SHD.dev(logits.detach().amax(-1))).flatten(0, 1)
    se = SHD.psum(torch.exp(logits - mx[..., None]).sum(-1))
    logz = torch.log(se) + mx
    lo = (SHD.model_index() * vl).view(-1, *([1] * labels.dim()))
    local = SHD.dev(labels) - lo
    inside = ((local >= 0) & (local < vl)).flatten(0, 1)
    local = local.flatten(0, 1).clamp(0, vl - 1)
    got = logits.gather(-1, local[..., None])[..., 0]
    tgt = SHD.psum(torch.where(inside, got,
                               torch.zeros((), device=got.device)))
    return logz, tgt


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
    """One device: ``make_train_step(cfg, pcfg, ocfg=None, donate=True)
    -> step_fn``.  A mesh: ``make_train_step(cfg, mesh, pcfg, ocfg=None,
    donate=True) -> (step_fn, compile_step, state_shardings)`` (module
    docstring: ``donate`` updates the state in place).  A
    ``mesh`` as the second argument selects the second form."""
    if args and isinstance(args[0], Mesh):
        return _mesh_train_step(cfg, *args, **kw)
    return _train_step(cfg, *args, **kw)


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


def _donated(state: TrainState, err_fb, donate: bool):
    """The step counter and error feedback of the next state: written
    into ``state``'s own tensors when ``donate``."""
    if not donate:
        return state.step + 1, err_fb
    if err_fb is not state.err_fb:
        adamw.tree_map(lambda old, new: old.copy_(new), state.err_fb, err_fb)
    return state.step.add_(1), state.err_fb


def _train_step(cfg: ModelConfig, pcfg: ParallelConfig,
                ocfg: Optional[adamw.OptConfig] = None, donate: bool = True):
    """The single-device ``step_fn(state, batch) -> (state, metrics)``;
    ``donate`` updates ``state`` in place (module docstring)."""
    ocfg = ocfg or adamw.OptConfig()

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
        params, opt, om = adamw.update(ocfg, grads, state.opt, state.params,
                                       inplace=donate)
        metrics = dict(metrics, loss=loss, **om)
        return TrainState(params, opt, *_donated(state, err_fb, donate)), \
            metrics

    return step_fn


_METRICS = ("loss", "ce", "aux", "zloss")


def _batch_axes(mesh: Mesh, bs) -> Tuple[str, ...]:
    """The mesh axes of more than one device that split the batch (its
    ``tokens``' dim 0, major first) under batch specs ``bs``."""
    lead = bs["tokens"] if isinstance(bs, dict) else bs
    split = dict(lead.dims()).get(0, ())
    return tuple(a for a in split if mesh.shape[a] > 1)


def _fold(x: torch.Tensor, sh: NamedSharding) -> torch.Tensor:
    """A laid-out batch leaf (n_local, ...) with its batch dim (dim 0, or
    1 for M-RoPE's (3, B, S) positions) folded with the local devices,
    device-major."""
    d = 1 if len(sh.spec) == 3 and sh.spec[0] is None and \
        sh.spec[1] is not None else 0
    return x.movedim(0, d).flatten(d, d + 1)


class Reps:
    """A stacked leaf's laid-out reps (one ``unbind``), each all-gathered
    to its compute slice where the model indexes it (``lm._layer``):
    inside the rep's function, so that a checkpointed rep gathers it again
    in its recompute and no rep's gathered copy outlives its use."""

    def __init__(self, parts, fetch):
        self.parts, self.fetch = parts, fetch

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, r: int) -> torch.Tensor:
        return self.fetch(self.parts[r])


def _stacked(path) -> bool:
    """A leaf with a stacked layer dim first: a stage's or the
    encoder's."""
    return str(path[0]).startswith("stage") or str(path[0]) == "encoder"


def compute_params(cfg: ModelConfig, mesh: Mesh, params, shardings,
                   batch_axes: Tuple[str, ...]):
    """The params the model computes with in a sharding context (under
    autograd where grad is on).  Each laid-out leaf is all-gathered
    (``shardings.gather``) but along a model split the compute shares
    (``shardings.compute_dim``).  A leaf the compute splits otherwise than
    its storage is cut to each device's compute slice after the gather
    (``shardings.model_slice``, whose backward all-gathers the slices'
    gradients).  A stacked layer leaf is cut into its reps by one
    ``unbind`` (whose backward writes the leaf's gradient once) and comes
    as :class:`Reps`: each rep is gathered where the model indexes it,
    inside the rep's (checkpointed, under ``cfg.remat``) function, the
    ZeRO-3 gather a layer; a leaf whose stored reps dim is split is first
    gathered along it, once.  Each leaf's gradient reduces over the batch
    axes, and over the model axis for a leaf the devices of a model group
    use whole (each holds a share of its gradient)."""
    c = SHD.ctx()

    def one(path, p, sh):
        shape = [n * math.prod(mesh.shape[a] for a in
                               dict(sh.dims()).get(d, ()))
                 for d, n in enumerate(p.shape[1:])]
        cd = SH.compute_dim(path, shape, cfg)
        pieces = SH.compute_pieces(path)
        keep = ()
        if cd is not None and pieces == 1 and \
                dict(sh.dims()).get(cd) == ("model",):
            keep = ("model",)
        sums = batch_axes + (("model",) if c.m > 1 and cd is None else ())

        def fetch(x, sh, cd, sums):
            x = SH.gather(x, sh, sums, keep)
            if cd is not None and not keep:
                x = SH.model_slice(x, cd, c.model, pieces)
            return x

        if not _stacked(path):
            return fetch(p, sh, cd, sums)
        # the reps dim itself split (a dense MLP under the reference's
        # first-match expert rule): gathered over its axes once, first
        lead = dict(sh.dims()).get(0, ())
        if lead:
            p = SH.gather(p, NamedSharding(mesh, P(sh.spec[0], *(
                [None] * (len(sh.spec) - 1)))),
                tuple(a for a in sums if a in lead))
            sums = tuple(a for a in sums if a not in lead)
        rep_sh = NamedSharding(mesh, P(*sh.spec[1:]))
        return Reps(p.movedim(0, 1).unbind(0), lambda x: fetch(
            x, rep_sh, None if cd is None else cd - 1, sums))

    return SH.tree_map(one, params, shardings, with_path=True)


def _mesh_train_step(cfg: ModelConfig, mesh: Mesh, pcfg: ParallelConfig,
                     ocfg: Optional[adamw.OptConfig] = None,
                     donate: bool = True):
    ocfg = ocfg or adamw.OptConfig()

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
        batch_axes = _batch_axes(mesh, bs)
        want = SH.tree_map(lambda x, sh: (mesh.n_local,)
                           + sh.local_shape(x.shape), state_shapes, ss)
        return lambda state, batch: _mesh_step(
            cfg, pcfg, ocfg, mesh, ss, want, bs, batch_axes, donate, state,
            batch)

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


def _mesh_step(cfg, pcfg, ocfg, mesh, ss, want, bs, batch_axes, donate,
               state: TrainState, batch) -> Tuple[TrainState, Dict]:
    """One step of the mesh form over a laid-out ``state`` (module
    docstring)."""
    SH.tree_map(_check_laid_out, state, want, with_path=True)
    folded = SH.tree_map(_fold, SH.shard(batch, bs), bs)
    ps = ss.params
    n_slices = math.prod(mesh.shape[a] for a in batch_axes)
    leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(),
                            state.params)
    with torch.enable_grad(), SHD.use_sharding(
            mesh, sharding_rules(pcfg), batch_axes=batch_axes):
        full = compute_params(cfg, mesh, leaves, ps, batch_axes)
        loss, m = loss_fn(cfg, pcfg, full, folded)
        # each batch slice's loss once: its model group's m replicas share
        total = loss.sum() / (n_slices * SHD.ctx().m)
        flat = adamw.tree_leaves(leaves)
        gs = torch.autograd.grad(total, flat, allow_unused=True)
    by_leaf = {id(p): g for p, g in zip(flat, gs)}
    grads = adamw.tree_map(lambda p: torch.zeros_like(p)
                           if by_leaf[id(p)] is None else by_leaf[id(p)],
                           leaves)
    # the global batch's means: each slice's, summed over the batch axes
    met = torch.stack([loss.detach()] + [m[k].detach().to(torch.float32)
                                         for k in _METRICS[1:]], dim=1)
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
    del flat, gs, by_leaf, leaves
    params, opt, om = adamw.update(ocfg, grads, state.opt, state.params,
                                   gnorm=gnorm, lead=1, inplace=donate)
    metrics = {k: met[0, j] for j, k in enumerate(_METRICS)}
    metrics.update(grad_norm=om["grad_norm"][0], lr=om["lr"][0])
    return TrainState(params, opt, *_donated(state, err_fb, donate)), metrics


# ---------------------------------------------------------------------------
# the prefill and decode steps over a mesh
# ---------------------------------------------------------------------------

def _logits_sharding(cfg: ModelConfig, mesh: Mesh,
                     batch: int) -> NamedSharding:
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    spec = SH._fit_spec([dp if dp else None, None, "model"],
                        (batch, 1, cfg.vocab_size), mesh)
    return NamedSharding(mesh, spec)


def _cache_folded(cfg: ModelConfig, cache, cs, mesh: Mesh):
    """Each laid-out cache leaf (n_local, reps, b, ...) as the folded
    (reps, n_local * b, ...) the model indexes, and what has to be written
    back after the step: the leaves whose fold copied (storage not
    layer-major) and the leaves split over the model axis where the
    compute keeps them whole (``shardings.cache_split``: GQA K/V whose KV
    heads do not split with the q heads, say), gathered whole over it
    here, each device's slice written back."""
    back = []

    def fold(path, x, sh):
        src, model_dim = x, None
        if mesh.shape.get("model", 1) > 1 and "model" in sh.axes() and \
                not SH.cache_split(path, cfg):
            model_dim = [d for d, a in sh.dims() if "model" in a][0]
            src = SH._gather(x, sh, keep=tuple(a for a in sh.axes()
                                               if a != "model"))
        v = src.movedim(0, 1)
        f = v.reshape((v.shape[0], -1) + tuple(v.shape[3:]))
        if model_dim is not None or (f.untyped_storage().data_ptr()
                                     != x.untyped_storage().data_ptr()):
            back.append((x, f, model_dim))
        return f
    return SH.tree_map(fold, cache, cs, with_path=True), back


def _write_back(back, mesh: Mesh) -> None:
    for x, f, model_dim in back:
        u = f.view((f.shape[0], x.shape[0], -1) + tuple(f.shape[2:]))
        u = u.movedim(1, 0)
        if model_dim is not None:
            u = SH._split(u, model_dim, mesh.shape["model"])[
                torch.arange(u.shape[0], device=u.device),
                mesh.axis("model").index()]
        x.copy_(u)


def _logits_out(logits: torch.Tensor, lg: NamedSharding, mesh: Mesh,
                vocab: int) -> torch.Tensor:
    """Folded logits (n_local * b, S, V') laid out by ``lg``: (n_local, b,
    S, V / p), each device's vocab slice cut from whole logits where the
    compute left them whole (``tensor_parallel=False``)."""
    out = SHD.dev(logits)
    if "model" in dict(lg.dims()).get(2, ()) and out.shape[-1] == vocab:
        v = SH._split(out, 2, mesh.shape["model"])
        out = v[torch.arange(out.shape[0], device=out.device),
                mesh.axis("model").index()]
    return out


def _serving_step(cfg, pcfg, mesh, ps, cs, bs, lg, params, cache, run):
    """The common part of the prefill and decode steps: ``run(full
    params, folded cache)`` in the sharding context, without grad, its
    logits laid out by ``lg``."""
    batch_axes = _batch_axes(mesh, bs)
    with torch.no_grad(), SHD.use_sharding(
            mesh, sharding_rules(pcfg), batch_axes=batch_axes):
        full = compute_params(cfg, mesh, params, ps, batch_axes)
        folded, back = _cache_folded(cfg, cache, cs, mesh)
        logits = run(full, folded)
        _write_back(back, mesh)
        return _logits_out(logits, lg, mesh, cfg.vocab_size), cache


def _serving_layout(cfg, mesh, pcfg, param_shapes, cache_shapes,
                    batch_shapes, batch: int):
    """The serving steps' layouts: params by ``param_spec``, the cache by
    ``cache_spec``, the batch (or tokens) by ``batch_specs``, the logits
    by :func:`_logits_sharding`."""
    return (SH.tree_shardings(param_shapes, mesh, SH.param_spec,
                              fsdp=pcfg.fsdp),
            SH.tree_shardings(cache_shapes, mesh, SH.cache_spec),
            SH.batch_specs(mesh, batch_shapes),
            _logits_sharding(cfg, mesh, batch))


def _full_step(step, layout, params, cache, *rest):
    """``step_fn`` of the serving steps: full params and cache laid out,
    stepped, the cache written back IN PLACE; full logits."""
    ps, cs, _, lg = layout
    laid = SH.shard(cache, cs, stack_dim=1)
    logits, laid = step(SH.shard(params, ps), laid, *rest)
    SH.tree_map(lambda c, x: c.copy_(x), cache, SH.unshard(laid, cs))
    return SH.unshard({"l": logits}, {"l": lg})["l"], cache


def make_prefill_step(cfg: ModelConfig, mesh: Mesh, pcfg: ParallelConfig):
    """Inference-prefill over a mesh: causal forward + KV-cache population
    (module docstring); an enc-dec config's batch holds ``enc_embeds``."""

    def step_of(layout):
        ps, cs, bs, lg = layout

        def step(params, cache, batch):
            b = SH.tree_map(_fold, SH.shard(batch, bs), bs)
            return _serving_step(
                cfg, pcfg, mesh, ps, cs, bs, lg, params, cache,
                lambda full, c: lm.forward(
                    cfg, full, b["tokens"], positions=b.get("positions"),
                    enc_embeds=b.get("enc_embeds"), cache=c,
                    mode="prefill", moe_groups=pcfg.moe_groups)[0])
        return step

    def layout_of(params, cache, batch):
        return _serving_layout(cfg, mesh, pcfg, params, cache, batch,
                               batch["tokens"].shape[0])

    def compile_step(param_shapes, cache_shapes, batch_shapes):
        return step_of(layout_of(param_shapes, cache_shapes, batch_shapes))

    def step_fn(params, cache, batch):
        layout = layout_of(params, cache, batch)
        return _full_step(step_of(layout), layout, params, cache, batch)

    return step_fn, compile_step


def make_serve_step(cfg: ModelConfig, mesh: Mesh, pcfg: ParallelConfig):
    """One decode step over a mesh at a uniform position (the reference's
    over ``lm.decode_step``; module docstring)."""

    def step_of(layout):
        ps, cs, ts, lg = layout

        def step(params, cache, tokens, pos):
            t = _fold(SH.shard(tokens, ts), ts)
            return _serving_step(
                cfg, pcfg, mesh, ps, cs, ts, lg, params, cache,
                lambda full, c: lm.decode_step(
                    cfg, full, c, t, pos, moe_groups=pcfg.moe_groups)[0])
        return step

    def layout_of(params, cache, tokens):
        return _serving_layout(cfg, mesh, pcfg, params, cache, tokens,
                               tokens.shape[0])

    def compile_step(param_shapes, cache_shapes, token_shapes):
        return step_of(layout_of(param_shapes, cache_shapes, token_shapes))

    def step_fn(params, cache, tokens, pos):
        layout = layout_of(params, cache, tokens)
        return _full_step(step_of(layout), layout, params, cache, tokens,
                          pos)

    return step_fn, compile_step
