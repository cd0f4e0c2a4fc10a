# Port of src/repro/models/sharding.py in torch: DEFAULT_RULES,
# use_sharding, spec_for, active and constrain's fit rule (``fit``, which
# ``parts`` applies: the port lays out its tensors itself, so nothing calls
# a constrain).  Port only: the
# split compute that XLA derives from the reference's constraints, written
# out as per-device matmuls and the model axis's collectives.
"""Logical-axis sharding threaded through the model code.

The reference calls ``constrain(x, "batch", "seq", None)`` at the model's
call sites and XLA splits the compute there.  The port writes the split
out.  Inside :func:`use_sharding` (the mesh steps install it) the model
runs on the local devices of a mesh *folded into the batch*, device-major:
activations are ``(n_local * B, S, M)`` and local device i's rows are
``i * B:(i + 1) * B``.  Devices of one ``model`` group hold the same rows,
so a ``model`` group computes one batch slice between them:

  column-parallel   ``matmul(x, w)`` with each device's weight slice
                    ``w`` (n_local, M, F / m): heads, ``ff``, vocab,
                    experts;
  row-parallel      the same matmul over the slice's rows, its partial
                    sums reduced over ``model`` (:func:`reduce_out`: an
                    all-reduce, or under sequence parallelism a
                    reduce-scatter on S);
  sequence (SP)     between blocks each device of a group keeps S / m of
                    the rows' tokens (``seq_sp``); :func:`gather_in`
                    all-gathers them before a block.

Every layer kind splits so: GQA and cross attention and the encoder over
heads, MLA over its query heads, mamba over its ``inner`` channels, rwkv
over its heads and ``ff``, MLPs over ``ff`` and experts.  A param a
block applies elementwise or per device (a scale, a bias, a conv tap,
mamba's ``A``) goes through :func:`mul`, :func:`add` or :func:`rows`, a
weight in an einsum through :func:`einsum`; a row-parallel product that
the block needs whole (mamba's ``x_proj``, rwkv's ``cm_wv``) through
:func:`psum_split`.  A checkpointed block's recompute runs in its
forward's context (:func:`installed`).

Every parameter leaf the model sees in a context carries the local devices
on dim 0 (a stacked layer dim follows it and is indexed away per layer),
each its device's compute slice; the model reads from a leaf's shape
whether it is split.  The collectives are the model axis's
(``launch/mesh.py``): under autograd, an all-reduce's backward is an
all-reduce, an all-gather's a reduce-scatter and back (Megatron's f/g
pair).  Outside a context every helper is the plain op, so the
single-device path and its numbers are unchanged.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]

# Megatron-style default: batch over (pod, data); heads/ff/experts/vocab over
# model; sequence sharded over model *between* layers (sequence parallelism)
# only when the rule set enables it.
DEFAULT_RULES: Mapping[str, Axis] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": None,          # layer-boundary sequence axis (SP off by default)
    "dmodel": None,
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "experts": "model",
    "vocab": "model",
    "state": None,
    "inner": "model",        # SSM/RWKV channel axis
}

_CTX: contextvars.ContextVar = contextvars.ContextVar("lisa_sharding",
                                                      default=None)


class _Ctx:
    """What the model reads of an active context."""

    def __init__(self, mesh, rules, batch_axes):
        self.mesh, self.rules = mesh, rules
        self.n = mesh.n_local
        self.batch_axes = tuple(a for a in batch_axes if mesh.shape[a] > 1)
        m = mesh.shape.get("model", 1)
        # the model axis splits the compute only where it does not split
        # the batch (tensor_parallel=False puts the batch over it)
        self.m = m if m > 1 and "model" not in self.batch_axes else 1
        self.model = mesh.axis("model") if self.m > 1 else None
        self.sp = self.m > 1 and rules.get("seq_sp") == "model"
        self.n_slices = math.prod(mesh.shape[a] for a in self.batch_axes)
        # each local device's batch slice, major axis first
        pos = {a: i for i, a in enumerate(mesh.axis_names)}
        coords = mesh.coords()
        self.slice_of = []
        for c in coords:
            k = 0
            for a in self.batch_axes:
                k = k * mesh.shape[a] + int(c[pos[a]])
            self.slice_of.append(k)


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[Mapping[str, Axis]] = None, *,
                 batch_axes: Optional[Sequence[str]] = None):
    """Install ``rules`` (over DEFAULT_RULES) for ``mesh``; a rule's axes
    that the mesh lacks are dropped.  ``batch_axes`` (port only) are the
    mesh axes the batch is split over, major first (default: the
    ``batch`` rule's)."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    names = set(mesh.axis_names)

    def filt(ax: Axis) -> Axis:
        if ax is None:
            return None
        if isinstance(ax, str):
            return ax if ax in names else None
        kept = tuple(a for a in ax if a in names)
        return kept if kept else None

    merged = {k: filt(v) for k, v in merged.items()}
    if batch_axes is None:
        b = merged["batch"]
        batch_axes = () if b is None else ((b,) if isinstance(b, str)
                                           else b)
    token = _CTX.set(_Ctx(mesh, merged, batch_axes))
    try:
        yield
    finally:
        _CTX.reset(token)


@contextlib.contextmanager
def installed(c: Optional["_Ctx"]):
    """The context ``c`` (from :func:`ctx`, or None) installed again: a
    checkpointed block's recompute runs in its forward's context, wherever
    the backward runs."""
    token = _CTX.set(c)
    try:
        yield
    finally:
        _CTX.reset(token)


def active() -> bool:
    return _CTX.get() is not None


def spec_for(*logical: Optional[str]):
    """The mesh axes of each logical axis under the active rules (None
    outside a context)."""
    c = _CTX.get()
    if c is None:
        return None
    return tuple(c.rules.get(ax) if ax is not None else None
                 for ax in logical)


def fit(ax: Axis, dim: int, sizes: Mapping[str, int]) -> Axis:
    """constrain's fit rule: the axes of ``ax`` that divide ``dim``, in
    order (an axis that does not divide what the earlier ones left is
    dropped); None when none does."""
    if ax is None:
        return None
    axes = (ax,) if isinstance(ax, str) else tuple(ax)
    kept, total = [], 1
    for a in axes:
        if dim % (total * sizes[a]) == 0:
            kept.append(a)
            total *= sizes[a]
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else tuple(kept)


# ---------------------------------------------------------------------------
# what the split compute reads (port only)
# ---------------------------------------------------------------------------

def ctx() -> Optional[_Ctx]:
    return _CTX.get()


def parts(logical: str, dim: int) -> int:
    """How many ways the compute splits a dim of size ``dim`` on the
    logical axis ``logical`` (the reference's ``constrain`` on it): the
    model axis's size where the rule maps it there, the model axis splits
    the compute and :func:`fit` keeps it; else 1 (also outside a
    context)."""
    c = _CTX.get()
    if c is None or c.m == 1:
        return 1
    return c.m if fit(c.rules.get(logical), dim, c.mesh.shape) == "model" \
        else 1


def n_local() -> int:
    c = _CTX.get()
    return 1 if c is None else c.n


def model_index() -> torch.Tensor:
    """(n_local,) int64: each local device's position on the model axis."""
    return _CTX.get().model.index()


def dev(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The folded batch dim ``dim`` of ``x`` split into (n_local, rows)."""
    return x.unflatten(dim, (n_local(), -1))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; in a context ``x`` (n_local * B, ..., K) and ``w``
    (n_local, K, F), each device's rows times its own weight."""
    if _CTX.get() is None:
        return x @ w
    n, K, F = w.shape
    y = torch.bmm(x.reshape(n, -1, K), w)
    return y.reshape(*x.shape[:-1], F)


def add(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x + b`` for a bias over the last dim; in a context ``b`` is
    (n_local, F)."""
    if _CTX.get() is None:
        return x + b
    n = b.shape[0]
    shape = (n,) + (1,) * (x.dim() - 1) + tuple(b.shape[1:])
    return (dev(x) + b.view(shape)).flatten(0, 1)


def mul(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x * s`` for a scale over x's trailing dims; in a context ``s`` is
    (n_local, ...), each device's over its rows."""
    if _CTX.get() is None:
        return x * s
    d = dev(x)
    return (d * per_device(s, d)).flatten(0, 1)


def rows(p: torch.Tensor, B: int) -> torch.Tensor:
    """``p[None]``, a param broadcast over a batch; in a context ``p``
    (n_local, ...) repeated for each of its device's rows of a folded
    batch of ``B``: (B, ...)."""
    if _CTX.get() is None:
        return p[None]
    n = p.shape[0]
    return p[:, None].expand(n, B // n, *p.shape[1:]).flatten(0, 1)


def einsum(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` of an activation ``x`` (its batch first)
    and a weight ``w``; in a context ``x`` folded and ``w`` (n_local,
    ...), each device's rows with its own weight."""
    if _CTX.get() is None:
        return torch.einsum(eq, x, w)
    lhs, out = eq.split("->")
    a, b = lhs.split(",")
    return torch.einsum(f"N{a},N{b}->N{out}", dev(x), w).flatten(0, 1)


def psum_split(y: torch.Tensor, split: bool) -> torch.Tensor:
    """A row-parallel product whole on every device: ``y`` summed over the
    model axis where its weight was ``split`` (:func:`psum`), else
    ``y``."""
    return psum(y) if split and _CTX.get() is not None else y


def per_device(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``scale`` (n_local, *s) shaped to broadcast over ``dev(x)``."""
    shape = ((scale.shape[0],) + (1,) * (x.dim() - scale.dim())
             + tuple(scale.shape[1:]))
    return scale.view(shape)


def norm(fn: Callable, x: torch.Tensor, scale: torch.Tensor,
         *a) -> torch.Tensor:
    """``fn(x, scale, *a)`` (a norm over the last dim); in a context the
    scale is (n_local, M), each device's copy over its rows."""
    if _CTX.get() is None:
        return fn(x, scale, *a)
    d = dev(x)
    return fn(d, per_device(scale, d), *a).flatten(0, 1)


def sp_on(seq: int) -> bool:
    """Whether the layer-boundary activations of a forward over ``seq``
    tokens are split on S (``seq_sp`` under constrain's fit rule)."""
    c = _CTX.get()
    return c is not None and c.sp and seq % c.m == 0


def psum(y: torch.Tensor) -> torch.Tensor:
    """The row-parallel reduction: ``y`` summed over the model axis, under
    autograd (its backward sums the gradient over it too)."""
    return _CTX.get().model.all_reduce(dev(y)).flatten(0, 1)


def reduce_out(y: torch.Tensor, partial: bool, sp: bool) -> torch.Tensor:
    """A block's output in the layout between blocks: ``partial`` sums
    (each device's share of a row-parallel product) reduced over the model
    axis, all-reduced, or reduce-scattered on S under ``sp``; a whole
    output under ``sp`` cut to the device's S chunk.  Outside a context,
    ``y``."""
    c = _CTX.get()
    if c is None or c.m == 1:
        return y
    if partial:
        if sp:
            return c.model.scatter_along(dev(y), 2).flatten(0, 1)
        return psum(y)
    if sp:
        S = y.shape[1] // c.m
        d = dev(y)
        idx = (c.model.index()[:, None] * S
               + torch.arange(S, device=y.device))
        idx = idx.view(c.n, 1, S, *([1] * (y.dim() - 2))).expand(
            c.n, d.shape[1], S, *y.shape[2:])
        return torch.gather(d, 2, idx).flatten(0, 1)
    return y


def gather_in(h: torch.Tensor, sp: bool) -> torch.Tensor:
    """A block's input: under ``sp`` the devices' S chunks all-gathered
    (its backward reduce-scatters); else ``h``."""
    if not sp:
        return h
    return _CTX.get().model.gather_along(dev(h), 2).flatten(0, 1)
