# Port of src/repro/train/shardings.py in torch: the rules, param_spec,
# cache_spec, tree_shardings and batch_specs, with P and NamedSharding as
# small classes of the port.  Port only: what each device holds under a
# spec (local_shape, shard), unshard by the ring all-gather, gather, the
# all-gather under autograd that the mesh training step runs, and
# compute_dim, compute_pieces and cache_split, the layout of the split
# compute.
"""Parameter / cache / batch PartitionSpecs (FSDP x TP, path-based rules).

TP (Megatron) over "model": attention heads, FFN hidden, experts, vocab.
FSDP (ZeRO-3) over "data" (+"pod"): the remaining large dim of every matrix,
gathered on use.  Stacked layer dims (leading axes added by
scan-over-layers) are never sharded — rules match the *trailing* dims.

A laid-out leaf is one tensor whose dim 0 holds the mesh's LOCAL devices
(all of a stacked mesh's, one on a rank), each its slice of the full leaf:
``shard`` cuts them, ``unshard`` and ``gather`` put them back together
over the mesh's axes (``core/lisa/rbm.py``'s ring all-gather).
"""
from __future__ import annotations

import math
import re
from typing import Any, Callable, Sequence, Tuple

import torch

from repro_torch.core.lisa import rbm

# (regex on the param path, spec for the trailing dims) — ORDERED: the first
# match wins, so expert (3-D) rules must precede the generic 2-D matmul rules
# they would otherwise be shadowed by.
_PARAM_RULES = [
    # MoE experts (E over model = EP; fsdp over d_model)
    (r"mlp/wi_gate$|mlp/wi_up$", ("model", "fsdp", None)),
    (r"mlp/wo$", ("model", None, "fsdp")),
    (r"router$", (None, None)),
    # embeddings / head
    (r"embed$", ("model", "fsdp")),                  # (V, M)
    (r"head$", ("fsdp", "model")),                   # (M, V)
    # attention (column-parallel in, row-parallel out)
    (r"wq$|wk$|wv$", ("fsdp", "model")),
    (r"wo$", ("model", "fsdp")),
    (r"bq$|bk$|bv$", ("model",)),
    # MLA
    (r"q_a$|kv_a$", ("fsdp", None)),
    (r"q_b$|kv_b$", (None, "model")),
    # dense MLP
    (r"wi_gate$|wi_up$", ("fsdp", "model")),
    # Mamba
    (r"in_proj$", ("fsdp", "model")),
    (r"conv_w$", (None, "model")),
    (r"conv_b$|dt_bias$|D$", ("model",)),
    (r"x_proj$", ("model", None)),
    (r"dt_w$", (None, "model")),
    (r"A_log$", ("model", None)),
    (r"out_proj$", ("model", "fsdp")),
    # RWKV
    (r"w1$", ("fsdp", None)),
    (r"w2$", (None, "model")),
    (r"u$", ("model", None)),
    (r"cm_wk$", ("fsdp", "model")),
    (r"cm_wv$", ("model", "fsdp")),
    (r"cm_wr$", ("fsdp", "model")),
]

_CACHE_RULES = [
    (r"k_scale$|v_scale$", (("pod", "data"), None, "kv_model")),
    (r"cc_scale$|cr_scale$", (("pod", "data"), None)),
    (r"/k$|/v$|enc_k$|enc_v$", (("pod", "data"), None, "kv_model", None)),
    (r"/pos$|enc_pos$", (("pod", "data"), None)),
    (r"/cc$|/cr$", (("pod", "data"), None, None)),
    (r"conv$", (("pod", "data"), None, "model")),
    (r"ssm$", (("pod", "data"), "model", None)),
    (r"att_shift$|ffn_shift$", (("pod", "data"), None)),
    (r"wkv$", (("pod", "data"), "model", None, None)),
]


class P(tuple):
    """A PartitionSpec: one entry a dim, each None, an axis name or a
    tuple of names (the dim split over them, the first the major)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class NamedSharding:
    """``spec`` over ``mesh``: how a full leaf is split among the mesh's
    devices."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, P(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def dims(self) -> Tuple[Tuple[int, Tuple[str, ...]], ...]:
        """``(dim, axis names)`` of every split dim, in dim order."""
        return tuple((d, (a,) if isinstance(a, str) else tuple(a))
                     for d, a in enumerate(self.spec) if a is not None)

    def axes(self) -> Tuple[str, ...]:
        """The axes the leaf is split over."""
        return tuple(a for _, names in self.dims() for a in names)

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of each device's slice of a leaf of ``shape``."""
        out = list(shape)
        for d, names in self.dims():
            out[d] //= math.prod(self.mesh.shape[a] for a in names)
        return tuple(out)

    def slices(self, shape: Sequence[int]) -> list:
        """Each local device's slice of a leaf of ``shape``: one tuple of
        ``slice`` a local device."""
        loc = self.local_shape(shape)
        pos = {a: i for i, a in enumerate(self.mesh.axis_names)}
        out = []
        for c in self.mesh.coords():
            idx = [slice(None)] * len(shape)
            for d, names in self.dims():
                k = 0
                for a in names:
                    k = k * self.mesh.shape[a] + int(c[pos[a]])
                idx[d] = slice(k * loc[d], (k + 1) * loc[d])
            out.append(tuple(idx))
        return out


def _path_str(path) -> str:
    """A path of dict keys, sequence indices or field names, joined by /
    (``"stage0/b0/mixer/wq"``)."""
    return "/".join(str(p) for p in path)


def _resolve(axis, mesh_axes, fsdp: bool, divisor_ok) -> Any:
    if axis == "fsdp":
        if not fsdp:
            return None
        cand = tuple(a for a in ("pod", "data") if a in mesh_axes)
        return cand if cand else None
    if axis == "kv_model":
        return "model" if "model" in mesh_axes else None
    if isinstance(axis, tuple):
        kept = tuple(a for a in axis if a in mesh_axes)
        return kept if kept else None
    if isinstance(axis, str):
        return axis if axis in mesh_axes else None
    return None


def _fit_spec(spec, shape, mesh):
    """Drop axes that don't divide the dim (e.g. kv heads < |model|)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    for ax, dim in zip(spec, shape):
        if ax is None:
            out.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else ax
        total = 1
        kept = []
        for a in axes:
            if dim % (total * sizes[a]) == 0:
                kept.append(a)
                total *= sizes[a]
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return P(*out)


def param_spec(path, leaf, mesh, fsdp: bool = True) -> P:
    s = _path_str(path)
    for pat, trailing in _PARAM_RULES:
        if re.search(pat, s):
            resolved = [_resolve(a, mesh.axis_names, fsdp, None)
                        for a in trailing]
            lead = leaf.ndim - len(resolved)
            spec = [None] * lead + resolved
            return _fit_spec(spec, leaf.shape, mesh)
    return P(*([None] * leaf.ndim))


def cache_spec(path, leaf, mesh) -> P:
    s = _path_str(path)
    for pat, trailing in _CACHE_RULES:
        if re.search(pat, s):
            resolved = [_resolve(a, mesh.axis_names, True, None)
                        for a in trailing]
            lead = leaf.ndim - len(resolved)
            spec = [None] * lead + resolved
            return _fit_spec(spec, leaf.shape, mesh)
    return P(*([None] * leaf.ndim))


# ---------------------------------------------------------------------------
# trees: nested dicts and named tuples, None an empty subtree
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest, path: Tuple = (), with_path=False):
    """``fn`` over the leaves of ``tree`` (dicts, named tuples; ``rest``
    alike in structure), keeping the structure; with ``with_path`` it gets
    the leaf's path of keys first."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            path=path + (k,), with_path=with_path)
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest),
                                     path=path + (f,), with_path=with_path)
                            for f in tree._fields))
    return fn(path, tree, *rest) if with_path else fn(tree, *rest)


def tree_shardings(tree, mesh, spec_fn, **kw):
    return tree_map(lambda p, l: NamedSharding(mesh, spec_fn(p, l, mesh,
                                                             **kw)),
                    tree, with_path=True)


def batch_specs(mesh, batch_tree, dp_axes=("pod", "data")):
    dp = tuple(a for a in dp_axes if a in mesh.axis_names)
    def spec(path, leaf):
        s = [dp if dp else None] + [None] * (leaf.ndim - 1)
        # M-RoPE positions are (3, B, S): batch is dim 1
        if _path_str(path).endswith("positions") and leaf.ndim == 3:
            s = [None, dp if dp else None, None]
        return NamedSharding(mesh, _fit_spec(s, leaf.shape, mesh))
    return tree_map(spec, batch_tree, with_path=True)


# ---------------------------------------------------------------------------
# what each device holds (port only)
# ---------------------------------------------------------------------------

def shard(tree, shardings, stack_dim: int = 0):
    """Full leaves (any device) to laid-out ones on each sharding's mesh:
    ``(n_local, *local_shape)``, local device i's slice at i.  With
    ``stack_dim=1`` the local devices lie after each leaf's dim 0 in
    storage (a cache's layer dim: each layer's slices then fold into one
    batch without a copy, ``step.make_serve_step``)."""
    def cut(x, sh):
        x = x.to(sh.mesh.device)
        got = torch.stack([x[s] for s in sh.slices(x.shape)],
                          dim=min(stack_dim, x.dim()))
        return got.movedim(min(stack_dim, x.dim()), 0)
    return tree_map(cut, tree, shardings)


def _gather(x: torch.Tensor, sh: NamedSharding,
            keep: Tuple[str, ...] = ()) -> torch.Tensor:
    """Laid-out to ``(n_local, *full_shape)``: the ring all-gather over
    each split dim's axes, the minor axis first (an axis of one device is
    the identity); axes in ``keep`` stay split."""
    for d, names in sh.dims():
        for a in reversed(names):
            axis = sh.mesh.axis(a)
            if axis.size > 1 and a not in keep:
                x = rbm.ring_allgather(x, axis, dim=d)
    return x


def unshard(tree, shardings):
    """Laid-out leaves back to full tensors (local device 0's copy, on the
    mesh's device) by the ring all-gather: on ranks every rank takes
    part and gets the whole.  Each leaf's other copies are freed at once
    (a view of one would hold them all)."""
    return tree_map(lambda x, sh: _gather(x, sh)[0].clone(), tree,
                    shardings)


def _split(g: torch.Tensor, d: int, n: int) -> torch.Tensor:
    """``(local, ..., n*c, ...)`` on shard dim ``d`` to ``(local, n, ...,
    c, ...)``."""
    shape = g.shape
    v = g.reshape(shape[:d + 1] + (n, shape[d + 1] // n) + shape[d + 2:])
    return v.movedim(d + 1, 1)


def _grad_to_shards(g: torch.Tensor, sh: NamedSharding,
                    batch_axes: Tuple[str, ...],
                    keep: Tuple[str, ...] = ()) -> torch.Tensor:
    """The gradient of every local device's full copy to its stored
    slice's, by the rule of the mesh step: over an axis in ``batch_axes``
    (one that splits the batch, or whose devices each hold a share of the
    gradient) the copies' gradients are summed and scattered (the ring
    reduce-scatter); over one that does not they are equal, and each
    device keeps its own slice; a leaf whole along such an axis is summed
    over it (the ring all-reduce).  Axes in ``keep`` were not gathered:
    the gradient is already the slice's along them."""
    for d, names in reversed(sh.dims()):
        for a in names:
            axis = sh.mesh.axis(a)
            if axis.size == 1 or a in keep:
                continue
            v = _split(g, d, axis.size)
            if a in batch_axes:
                g = rbm.ring_reduce_scatter(v.contiguous(), axis)
            else:
                rows = torch.arange(g.shape[0], device=g.device)
                g = v[rows, axis.index()].contiguous()
    split = sh.axes()
    for a in batch_axes:
        if a not in split:
            g = rbm.ring_allreduce(g, sh.mesh.axis(a))
    return g


class _Gather(torch.autograd.Function):
    """All-gather forward; :func:`_grad_to_shards` backward."""

    @staticmethod
    def forward(ctx, x, sh, batch_axes, keep):
        ctx.sh, ctx.batch_axes, ctx.keep = sh, batch_axes, keep
        return _gather(x, sh, keep)

    @staticmethod
    def backward(ctx, g):
        return _grad_to_shards(g.contiguous(), ctx.sh, ctx.batch_axes,
                               ctx.keep), None, None, None


def gather(x: torch.Tensor, sh: NamedSharding,
           batch_axes: Tuple[str, ...] = (),
           keep: Tuple[str, ...] = ()) -> torch.Tensor:
    """``(n_local, *full_shape)`` from a laid-out leaf, under autograd:
    its backward takes the gradient of every local device's copy to the
    gradient of the stored slices (summed over ``batch_axes``, the axes
    over which devices hold shares of it).  Axes in ``keep`` stay split,
    forward and backward.  Without grad it is :func:`unshard`'s gather
    for all local devices."""
    return _Gather.apply(x, sh, tuple(batch_axes), tuple(keep))


class _ModelSlice(torch.autograd.Function):
    """Each local device's chunk of a whole copy; all-gather backward."""

    @staticmethod
    def forward(ctx, x, d, axis, pieces):
        ctx.d, ctx.axis, ctx.pieces = d, axis, pieces
        v = _split(x, d, pieces * axis.size)
        v = v.unflatten(1, (pieces, axis.size))
        rows = torch.arange(x.shape[0], device=x.device)
        got = v[rows, :, axis.index()]            # (local, pieces, ...)
        return got.movedim(1, d + 1).flatten(d + 1, d + 2).contiguous()

    @staticmethod
    def backward(ctx, g):
        d, n, k = ctx.d + 1, ctx.axis.size, ctx.pieces
        full = ctx.axis.gather_dim(g.contiguous(), d)   # device-major
        if k > 1:
            c = full.shape[d] // (n * k)
            full = full.unflatten(d, (n, k, c)).transpose(d, d + 1) \
                .flatten(d, d + 2)
        return full, None, None, None


def model_slice(x: torch.Tensor, d: int, axis,
                pieces: int = 1) -> torch.Tensor:
    """Of a gathered leaf ``(n_local, *full_shape)`` that every device of
    ``axis`` holds whole, each device's chunk along full dim ``d`` (chunk
    p at axis position p), under autograd: its backward all-gathers the
    chunks' gradients along ``d``, so each device gets the whole leaf's
    gradient (each chunk's from the one device that computed with it).
    With ``pieces`` > 1 the dim is that many equal parts side by side (a
    packed projection) and the device takes its chunk of each, in
    order."""
    return _ModelSlice.apply(x, d, axis, pieces)


# ---------------------------------------------------------------------------
# the compute layout of the split (port only)
# ---------------------------------------------------------------------------

# the leaves of a layer the split compute cuts, by kind: (column-split
# leaves, the dim of theirs it cuts counted from the last); a leaf of the
# kind not named is used whole
_SPLIT_LEAVES = {
    # MLA: the query heads; q_a, kv_a and the latent norms whole
    "mla": {"q_b": 1, "kv_b": 1, "wo": 2},
    # mamba: the inner channels; x_proj and out_proj are row-parallel
    "mamba": {"in_proj": 1, "conv_w": 1, "conv_b": 1, "dt_w": 1,
              "dt_bias": 1, "D": 1, "x_proj": 2, "A_log": 2,
              "out_proj": 2},
    # rwkv's time mix: the heads (the mixing weights and w1 whole)
    "rwkv": {"wk": 1, "wv": 1, "wr": 1, "wg": 1, "w2": 1, "w0": 1,
             "ln_x": 1, "u": 2, "wo": 2},
    # rwkv's channel mix: ff (the gate cm_wr whole)
    "rwkv_cm": {"cm_wk": 1, "cm_wv": 2},
    # cross attention (MHA): the heads
    "cross": {"wq": 1, "wk": 1, "wv": 1, "wo": 2},
}
# leaves whose cut dim packs parts side by side (mamba's [x_in | z])
_PIECES = {"in_proj": 2}


def _split_by(kind: str, cfg) -> bool:
    """Whether the split compute cuts a layer kind's leaves of
    :data:`_SPLIT_LEAVES` under the active context: its logical axis
    divides the model axis (the reference's constrain)."""
    from repro_torch.models import sharding as SHD
    from repro_torch.models.rwkv import HEAD_DIM
    if kind in ("mla", "cross"):
        return SHD.parts("heads", cfg.n_heads) > 1
    if kind == "mamba":
        return SHD.parts("inner", cfg.expand * cfg.d_model) > 1
    if kind == "rwkv":
        return SHD.parts("heads", cfg.d_model // HEAD_DIM) > 1
    return SHD.parts("ff", cfg.d_ff) > 1              # rwkv_cm


def compute_pieces(path) -> int:
    """The parts a leaf's cut dim packs (:func:`model_slice`'s
    ``pieces``): 2 for mamba's ``in_proj``, else 1."""
    return _PIECES.get(str(path[-1]), 1)


def compute_dim(path, shape: Sequence[int], cfg) -> Any:
    """The dim of a param leaf (full ``shape``) that the split compute
    keeps cut over the model axis under the active sharding context
    (``models/sharding.py``), or None where every device uses it whole:
    the vocab of ``embed``/``head``, the heads of a GQA layer's
    projections (its KV heads only where they divide too) and of the
    encoder's, ``ff`` of a dense MLP and of the shared experts, the
    experts of an MoE layer, and :data:`_SPLIT_LEAVES` of MLA, mamba,
    rwkv and cross attention, each where its logical axis divides the
    model axis.  Norms, routers, MLA's ``q_a``/``kv_a``, rwkv's mixing
    weights and gate ``cm_wr`` are used whole."""
    from repro_torch.models import sharding as SHD
    from repro_torch.models.lm import stages_of
    keys = [str(k) for k in path]
    nd = len(shape)
    if keys == ["embed"]:
        return nd - 2 if SHD.parts("vocab", cfg.vocab_size) > 1 else None
    if keys == ["head"]:
        return nd - 1 if SHD.parts("vocab", cfg.vocab_size) > 1 else None
    if len(keys) < 4:
        return None
    if keys[0] == "encoder":
        mixer, mlp = "attn_full", "dense"
    elif keys[0].startswith("stage"):
        mixer, mlp = stages_of(cfg)[int(keys[0][5:])][1][int(keys[1][1:])]
    else:
        return None
    name = keys[-1]
    if keys[2] == "cross" or keys[2] == "mixer" and mixer in (
            "mla", "mamba", "rwkv"):
        kind = "cross" if keys[2] == "cross" else mixer
        if mixer == "rwkv" and name.startswith("cm_"):
            kind = "rwkv_cm"
        back = _SPLIT_LEAVES[kind].get(name)
        return nd - back if back and _split_by(kind, cfg) else None
    if keys[2] == "mixer":
        heads = SHD.parts("heads", cfg.n_heads) > 1
        kv = heads and SHD.parts("kv_heads", cfg.n_kv_heads) > 1
        if name in ("wq", "bq") and heads or name in ("wk", "wv", "bk",
                                                      "bv") and kv:
            return nd - 1
        if name == "wo" and heads:
            return nd - 2
        return None
    if keys[2] != "mlp" or mlp not in ("dense", "moe"):
        return None
    if mlp == "moe" and len(keys) == 4:
        if name == "router" or SHD.parts("experts", cfg.n_experts) == 1:
            return None
        return nd - 3                    # (reps, E, rows, cols)
    ff = cfg.d_ff if mlp == "dense" else cfg.n_shared_experts * cfg.moe_d_ff
    if SHD.parts("ff", ff) == 1:
        return None
    return nd - 2 if name == "wo" else nd - 1


def cache_split(path, cfg) -> bool:
    """Whether the split compute keeps a cache leaf's model split (each
    device computes with its stored slice): GQA K/V where the KV heads
    split with the q heads, ``enc_k``/``enc_v`` where cross attention's
    heads split, mamba's ``conv``/``ssm`` where its inner channels do,
    rwkv's ``wkv`` where its heads do.  MLA's latents and rwkv's shifts
    are whole over the model axis: every device writes the same value."""
    from repro_torch.models import sharding as SHD
    name = str(path[-1])
    if name in ("k", "v", "k_scale", "v_scale"):
        return (SHD.parts("heads", cfg.n_heads) > 1
                and SHD.parts("kv_heads", cfg.n_kv_heads) > 1)
    kind = {"enc_k": "cross", "enc_v": "cross", "conv": "mamba",
            "ssm": "mamba", "wkv": "rwkv"}.get(name)
    return kind is not None and _split_by(kind, cfg)
