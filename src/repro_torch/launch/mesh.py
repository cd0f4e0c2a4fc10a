# Port of src/repro/launch/mesh.py in torch: make_local_mesh (:29-36), the
# production mesh as a layout with no devices (make_production_mesh,
# :9-26), and the axis objects that take the place of a named mesh axis.
"""Meshes and their axes for the LISA hop substrate: ranks, or a stack.

The reference runs its hop chains inside ``shard_map`` over a named mesh
axis.  The port names the axis by an object, and every function of
:mod:`repro_torch.core.lisa.rbm` takes tensors whose dim 0 is the LOCAL
devices of the axis (``n_local`` of them), so each is written once for
both kinds:

  GroupAxis    one rank a device of a ``torch.distributed`` group
               (``n_local = 1``): a hop is ``dist.batch_isend_irecv``
               between the ranks of its pairs, ``psum``/``pmax`` are
               ``dist.all_reduce``; gloo on the CPU, NCCL on
               ``cuda:LOCAL_RANK``.
  StackedAxis  one process holds all n shards stacked on dim 0, the
               counterpart of the reference's forced-host-device mesh
               (``tests/_multidev.py``): on the card a hop is ONE launch of
               the page gather K2 over the stack viewed as rows, whose
               table maps each destination's rows to its source's (rows of
               a device that receives nothing stay zero); on the CPU the
               same table runs through the plain gather.  One axis of a
               stacked mesh is a StackedAxis over the whole stack
               (``mesh_shape``, ``dim``): its hop applies the pairs inside
               every group of the axis at once, still one K2 launch, and
               ``psum``/``pmax`` reduce within each group.

A :class:`Mesh` names its axes ``("data", "model")`` as the reference's
``make_local_mesh`` does, its devices in the reference's row-major order:
``make_local_mesh(data, model)`` stacks all of them in one process (on one
card), ``Mesh.from_env(data, model)`` takes one ``torchrun`` rank a device
and gives each axis its ``dist.new_group`` subgroups.  ``mesh.axis(name)``
is the axis object that :mod:`repro_torch.core.lisa.rbm` takes.

``ppermute`` has ``jax.lax.ppermute``'s semantics: ``out[dst] = x[src]``
for each pair, zeros where a device receives nothing.  Each axis counts
its hops and its reductions in plain integers (``hops``, ``reductions``;
``reset_counts()`` zeroes them), and their bytes (``hop_bytes``,
``reduction_bytes``: one device's shard a hop, one device's operand a
reduction).  The split compute's collectives,
``all_reduce``, and the all-gather and reduce-scatter along a tensor dim
``gather_along`` and ``scatter_along``,
run under autograd (each backward the other's collective) and count as
reductions, forward and backward alike.
A tensor on another device than the axis's raises: no axis moves a tensor
to another device behind the caller's back.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device, to_device
from repro_torch.kernels import ops

# the largest row a StackedAxis views a shard as: K2 runs one warp a row
# and was tuned on 1 KiB pages (csrc/page_copy.cu), so a 550 MB shard is
# 537k rows, never one page
HOP_ROW_BYTES = 1024
_ALIGN = 16                        # K2's row size and alignment (_check_pool)

Pairs = Sequence[Tuple[int, int]]


def _check_pairs(pairs: Pairs, n: int) -> Tuple[Tuple[int, int], ...]:
    """``pairs`` as a tuple, raising as ``jax.lax.ppermute`` does on an
    index outside ``[0, n)`` or a source or destination named twice."""
    pairs = tuple((int(s), int(d)) for s, d in pairs)
    srcs, dsts = [s for s, _ in pairs], [d for _, d in pairs]
    if any(not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute pairs {pairs} outside an axis of {n}")
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute pairs {pairs} name a source or a "
                         f"destination twice")
    return pairs


def _axis_device(device) -> torch.device:
    """The device an axis lives on, with its index (``cuda`` is the
    current card's), so that it compares equal to its tensors' device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class _Done:
    """A hop whose result is already queued (a StackedAxis hop)."""

    def __init__(self, out: torch.Tensor):
        self._out = out

    def wait(self) -> torch.Tensor:
        return self._out


class _Axis:
    """What both axes share: the counters and the device check."""

    size: int
    n_local: int
    positions: Tuple[int, ...]     # each local device's index on the axis
    device: torch.device
    name: str

    def reset_counts(self) -> None:
        """Set the hop and reduction counters, and their byte counters, to
        0."""
        self.hops = 0
        self.reductions = 0
        self.hop_bytes = 0
        self.reduction_bytes = 0

    def _count(self, x: torch.Tensor, hop: bool) -> None:
        """Count one hop or reduction of ``x``: its bytes are one device's
        shard (what one device sends a hop, or reduces)."""
        nbytes = x.numel() // max(x.shape[0], 1) * x.element_size()
        if hop:
            self.hops += 1
            self.hop_bytes += nbytes
        else:
            self.reductions += 1
            self.reduction_bytes += nbytes

    def index(self) -> torch.Tensor:
        """``(n_local,)`` int64: this process's device positions (copied
        to the device once, without waiting for it)."""
        if self._index is None:
            self._index = to_device(list(self.positions), self.device,
                                    torch.int64)
        return self._index

    def mask(self, positions) -> torch.Tensor:
        """``(n_local,)`` bool: which local devices are in ``positions``."""
        wanted = set(positions)
        return to_device([p in wanted for p in self.positions], self.device,
                         torch.bool)

    def check(self, x: torch.Tensor) -> None:
        if x.device != self.device:
            raise ValueError(f"axis {self.name!r} lives on {self.device}; "
                             f"got a tensor on {x.device}")
        if x.dim() < 1 or x.shape[0] != self.n_local:
            raise ValueError(f"axis {self.name!r} takes tensors with a "
                             f"leading dim of {self.n_local} local devices; "
                             f"got {tuple(x.shape)}")

    def ppermute(self, x: torch.Tensor, pairs: Pairs) -> torch.Tensor:
        """``out[dst] = x[src]`` for each pair; zeros elsewhere."""
        return self.ppermute_start(x, pairs).wait()

    # the split compute's collectives, under autograd (models/sharding.py)
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`psum` whose backward is a psum of the gradient: the
        row-parallel reduction (Megatron's forward and backward
        all-reduce)."""
        return _AllReduce.apply(x, self)

    def gather_along(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Each device's ``x`` concatenated along tensor dim ``dim`` (dim 0
        is the local devices) in axis order, on every device; its backward
        reduce-scatters the gradient."""
        return _AllGather.apply(x, self, dim)

    def scatter_along(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` summed over the axis and cut into ``size`` chunks along
        ``dim``, device p keeping chunk p; its backward all-gathers the
        gradient."""
        return _ReduceScatter.apply(x, self, dim)


class StackedAxis(_Axis):
    """An axis of ``n`` devices held by one process, stacked on dim 0.

    Alone, the stack is the axis (``mesh_shape=(n,)``).  As axis ``dim`` of
    a stacked mesh of ``mesh_shape`` (devices in row-major order on dim 0),
    the stack holds ``prod(mesh_shape)`` devices, each group of the axis
    (the devices that differ only in coordinate ``dim``) is a ring of
    ``n``, and a hop's pairs apply in every group."""

    def __init__(self, n: int, device=None, name: str = "x", *,
                 mesh_shape: Sequence[int] = None, dim: int = 0):
        if n < 1:
            raise ValueError(f"an axis needs at least one device (got {n})")
        self.mesh_shape = (n,) if mesh_shape is None else tuple(
            int(m) for m in mesh_shape)
        if self.mesh_shape[dim] != n:
            raise ValueError(f"axis {name!r} of {n} devices is not dim "
                             f"{dim} of a mesh of {self.mesh_shape}")
        self.dim = dim
        self.size = n
        self.n_local = math.prod(self.mesh_shape)
        self._stride = math.prod(self.mesh_shape[dim + 1:])
        self.positions = tuple(int(c) for c in np.unravel_index(
            np.arange(self.n_local), self.mesh_shape)[dim])
        self.device = _axis_device(device)
        self.name = name
        self._index = None
        self.reset_counts()

    def _stack_pairs(self, pairs: Tuple[Tuple[int, int], ...]
                     ) -> Tuple[Tuple[int, int], ...]:
        """The pairs over the stack: each axis pair in every group."""
        if self.n_local == self.size:
            return pairs
        dst_of = dict(pairs)
        return tuple((f, f + (dst_of[c] - c) * self._stride)
                     for f, c in enumerate(self.positions) if c in dst_of)

    def ppermute_start(self, x: torch.Tensor, pairs: Pairs) -> _Done:
        self.check(x)
        pairs = _check_pairs(pairs, self.size)
        self._count(x, hop=True)
        return _Done(stacked_hop(x, self._stack_pairs(pairs)))

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        self.check(x)
        self._count(x, hop=False)
        g = x.reshape(self.mesh_shape + tuple(x.shape[1:]))
        return op(g, self.dim).expand(g.shape).reshape(x.shape).contiguous()

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, lambda g, d: g.sum(d, keepdim=True))

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, lambda g, d: g.amax(d, keepdim=True))

    def gather_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The all-gather along ``dim`` without autograd: a copy of the
        group's chunks for every device of it."""
        self.check(x)
        self._count(x, hop=False)
        nd = len(self.mesh_shape)
        g = x.reshape(self.mesh_shape + tuple(x.shape[1:]))
        c = torch.cat(g.unbind(self.dim), dim=nd - 2 + dim)
        rest = tuple(c.shape[nd - 1:])
        return c.unsqueeze(self.dim).expand(self.mesh_shape + rest).reshape(
            (self.n_local,) + rest)

    def scatter_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The reduce-scatter along ``dim`` without autograd: the group's
        sum, device p keeping chunk p."""
        self.check(x)
        self._count(x, hop=False)
        nd = len(self.mesh_shape)
        s = x.reshape(self.mesh_shape + tuple(x.shape[1:])).sum(self.dim)
        k = nd - 2 + dim
        s = s.unflatten(k, (self.size, -1)).movedim(k, self.dim)
        return s.reshape((self.n_local,) + tuple(s.shape[nd:]))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.psum(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.psum(g), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.gather_dim(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.scatter_dim(g.contiguous(), ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.scatter_dim(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.gather_dim(g.contiguous(), ctx.dim), None, None


def hop_rows(nbytes: int) -> int:
    """The row size a shard of ``nbytes`` is viewed as: the largest power
    of two that divides it, up to HOP_ROW_BYTES (0 when it is not a
    multiple of 16 and has to be padded)."""
    if nbytes % _ALIGN:
        return 0
    return min(nbytes & -nbytes, HOP_ROW_BYTES)


def hop_table(src_of: Sequence[int], rows: int,
              device: torch.device) -> torch.Tensor:
    """The K2 table of one hop over ``len(src_of)`` shards of ``rows``
    rows: destination ``d``'s rows read source ``src_of[d]``'s, in order;
    ``-1`` (keep ``out``'s zero) where ``src_of[d]`` is -1.  Built on
    ``device`` from a few host ints, so it costs no host copy of its
    n x rows entries."""
    src = to_device(list(src_of), device, torch.int32)
    r = torch.arange(rows, dtype=torch.int32, device=device)
    table = torch.where(src[:, None] >= 0, src[:, None] * rows + r, -1)
    return table.reshape(-1)


def stacked_hop(x: torch.Tensor, pairs: Tuple[Tuple[int, int], ...]
                ) -> torch.Tensor:
    """One hop over a stack: one page gather (K2 on the card) of the
    stack's rows.  A shard whose bytes are no multiple of 16, or a stack
    that is not 16-byte aligned, is first copied into staging rows padded
    to 16 bytes, and goes through the same gather."""
    n = x.shape[0]
    src_of = [-1] * n
    for s, d in pairs:
        src_of[d] = s
    x = x.contiguous()
    shard = x[0].numel() * x.element_size()
    if shard == 0:
        return torch.zeros_like(x)
    row = hop_rows(shard)
    staged = not row or x.data_ptr() % _ALIGN
    if staged:
        padded = -(-shard // _ALIGN) * _ALIGN
        row = hop_rows(padded)
        data = torch.zeros((n, padded), dtype=torch.uint8, device=x.device)
        data[:, :shard] = x.reshape(n, -1).view(torch.uint8)
    else:
        data = x.reshape(n, -1).view(torch.uint8)
    per = data.shape[1] // row
    rows = data.view(n * per, row)
    # every device receives in a full permutation; only then may the
    # output start uninitialised
    out = None if -1 not in src_of else torch.zeros_like(rows)
    got = ops.villa_gather(rows, hop_table(src_of, per, x.device), out)
    got = got.view(n, -1)
    if staged:
        got = got[:, :shard].contiguous()
    return got.view(x.dtype).view(x.shape)


class GroupAxis(_Axis):
    """An axis whose devices are the ranks of a process group, one each."""

    def __init__(self, group=None, device=None, name: str = "x"):
        self.group = dist.group.WORLD if group is None else group
        dev = resolve_device(device)
        backend = dist.get_backend(self.group)
        want = "nccl" if dev.type == "cuda" else "gloo"
        if backend != want:
            raise ValueError(f"a GroupAxis on {dev} needs a {want} group "
                             f"(got {backend})")
        self.device = _axis_device(dev)
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.n_local = 1
        self.positions = (self.rank,)
        self.name = name
        self._index = None
        self.reset_counts()

    @classmethod
    def from_env(cls, device=None, name: str = "x") -> "GroupAxis":
        """The world group of a process started by ``torchrun`` (its
        ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
        ``MASTER_PORT``), initialised here unless it already is: NCCL on
        ``cuda:LOCAL_RANK`` by default, gloo with ``device="cpu"``."""
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", local)
            torch.cuda.set_device(dev)
        if not dist.is_initialized():
            addr = os.environ["MASTER_ADDR"]
            port = os.environ["MASTER_PORT"]
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method=f"tcp://{addr}:{port}", rank=rank,
                world_size=world, **({"device_id": dev}
                                     if dev.type == "cuda" else {}))
        return cls(None, dev, name)

    def ppermute_start(self, x: torch.Tensor, pairs: Pairs):
        """Post this rank's sends and receives of one hop and return a
        handle whose ``wait()`` gives the result: only the ranks of a pair
        talk, and a rank that receives nothing gets zeros at once."""
        self.check(x)
        pairs = _check_pairs(pairs, self.size)
        self._count(x, hop=True)
        x = x.contiguous()
        out = torch.zeros_like(x)
        p2p = []
        for s, d in pairs:
            if s == d == self.rank:
                out.copy_(x)
            elif s == self.rank:
                p2p.append(dist.P2POp(dist.isend, x, dist.get_global_rank(
                    self.group, d), self.group))
            elif d == self.rank:
                p2p.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(
                    self.group, s), self.group))
        return _Posted(dist.batch_isend_irecv(p2p) if p2p else [], out, x)

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        self.check(x)
        self._count(x, hop=False)
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=op, group=self.group)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def gather_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        self.check(x)
        self._count(x, hop=False)
        x = x.contiguous()
        bufs = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(bufs, x, group=self.group)
        return torch.cat(bufs, dim)

    def scatter_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The group's sum by ``dist.all_reduce`` (gloo has no
        reduce-scatter), this rank keeping its chunk."""
        self.check(x)
        self._count(x, hop=False)
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out.chunk(self.size, dim)[self.rank].contiguous()


class _Posted:
    """A GroupAxis hop in flight; ``wait()`` ends it.  Holds the sent
    tensor until then, so its storage outlives the send."""

    def __init__(self, works, out: torch.Tensor, sent: torch.Tensor):
        self._works, self._out, self._sent = works, out, sent

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        self._works, self._sent = [], None
        return self._out


class Mesh:
    """A (data, model) mesh: ``axis_names``, ``shape`` (name -> size),
    ``devices`` (the device ids in the reference's ``reshape(data,
    model)`` order: stack positions, or ranks), this process's devices
    ``local`` (flat ids, the leading dim of every local tensor) and an
    axis object per name.  ``stacked`` tells the two kinds apart."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 axes: Dict[str, _Axis], local: Sequence[int],
                 device: torch.device, stacked: bool):
        self.axis_names = tuple(axis_names)
        self.devices = np.arange(math.prod(shape)).reshape(tuple(shape))
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self._axes = dict(axes)
        self.local = tuple(local)
        self.n_local = len(self.local)
        self.device = device
        self.stacked = stacked

    def axis(self, name: str) -> _Axis:
        return self._axes[name]

    def coords(self) -> np.ndarray:
        """``(n_local, len(axis_names))``: each local device's coordinate
        on every axis."""
        return np.stack(np.unravel_index(np.asarray(self.local),
                                         self.devices.shape), axis=1)

    def reset_counts(self) -> None:
        for a in self._axes.values():
            a.reset_counts()

    def counts(self) -> Dict[str, Tuple[int, int]]:
        """``{axis name: (hops, reductions)}``."""
        return {n: (a.hops, a.reductions) for n, a in self._axes.items()}

    def byte_counts(self) -> Dict[str, Tuple[int, int]]:
        """``{axis name: (hop bytes, reduction bytes)}``: the bytes one
        device sent over the hops, and reduced, since the last reset."""
        return {n: (a.hop_bytes, a.reduction_bytes)
                for n, a in self._axes.items()}

    def __repr__(self) -> str:
        kind = "stacked" if self.stacked else "ranks"
        return f"Mesh({self.shape}, {kind}, {self.device})"

    @classmethod
    def from_env(cls, data: int = 1, model: int = 1, device=None) -> "Mesh":
        """One ``torchrun`` rank a device (``WORLD_SIZE == data * model``;
        rank r is device r of the row-major mesh): the world group is
        initialised as :meth:`GroupAxis.from_env` does, and each axis gets
        a GroupAxis over its subgroups (every rank creates every subgroup,
        in one order, as ``dist.new_group`` asks)."""
        world = int(os.environ["WORLD_SIZE"])
        if world != data * model:
            raise ValueError(f"a {data} x {model} mesh takes {data * model} "
                             f"ranks; WORLD_SIZE is {world}")
        world_axis = GroupAxis.from_env(device=device, name="world")
        ids = np.arange(world).reshape(data, model)
        rank = world_axis.rank
        axes = {}
        for d, name in enumerate(("data", "model")):
            lines = np.moveaxis(ids, d, -1).reshape(-1, ids.shape[d])
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    axes[name] = GroupAxis(group, world_axis.device, name)
        return cls((data, model), ("data", "model"), axes, (rank,),
                   world_axis.device, stacked=False)


def make_local_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """The reference's ``make_local_mesh``: a (data, model) mesh whose
    ``data * model`` devices one process holds stacked on dim 0 of every
    local tensor, on ``device`` (default: cuda, raising without a GPU)."""
    if data < 1 or model < 1:
        raise ValueError(f"a mesh needs at least one device an axis (got "
                         f"{data} x {model})")
    dev = _axis_device(device)
    shape = (data, model)
    axes = {name: StackedAxis(n, dev, name, mesh_shape=shape, dim=d)
            for d, (name, n) in enumerate(zip(("data", "model"), shape))}
    return Mesh(shape, ("data", "model"), axes, range(data * model), dev,
                stacked=True)


class LayoutAxis:
    """An axis of a :class:`LayoutMesh`: its ``name`` and ``size``, no
    local devices; every operation raises."""

    n_local = 0
    positions: Tuple[int, ...] = ()

    def __init__(self, name: str, size: int):
        self.name, self.size = name, size

    def _refuse(self, *args, **kwargs):
        raise RuntimeError(f"axis {self.name!r} of a layout-only mesh has no "
                           f"devices: it cannot move or reduce a tensor")

    ppermute = ppermute_start = psum = pmax = gather_dim = scatter_dim = \
        all_reduce = gather_along = scatter_along = index = mask = \
        reset_counts = _refuse


class LayoutMesh(Mesh):
    """A mesh that is a layout only: axis names and sizes, no devices.
    ``train/shardings.py``'s specs and local shapes, and the sharding
    context's rules, read only ``axis_names``, ``shape`` and
    ``devices.shape``; it has no local devices (``coords()`` is empty), and
    every operation of its axes (:class:`LayoutAxis`) raises, as do its
    counters."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        axes = {a: LayoutAxis(a, int(n)) for a, n in zip(axis_names, shape)}
        super().__init__(shape, axis_names, axes, (), torch.device("meta"),
                         stacked=False)

    def coords(self) -> np.ndarray:
        return np.zeros((0, len(self.axis_names)), np.int64)

    def reset_counts(self) -> None:
        raise RuntimeError("a layout-only mesh has no axis counters")

    def counts(self) -> Dict[str, Tuple[int, int]]:
        raise RuntimeError("a layout-only mesh has no axis counters")

    def byte_counts(self) -> Dict[str, Tuple[int, int]]:
        raise RuntimeError("a layout-only mesh has no axis counters")

    def __repr__(self) -> str:
        return f"LayoutMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> LayoutMesh:
    """The reference's production mesh as a layout: 16 x 16 over (data,
    model) for one pod, 2 x 16 x 16 over (pod, data, model) across pods.
    It holds no devices (the dry run lays out each cell without them) and
    any axis operation on it raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LayoutMesh(shape, axes)
