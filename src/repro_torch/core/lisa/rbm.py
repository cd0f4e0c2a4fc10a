# Port of src/repro/core/lisa/rbm.py:25-197 in torch: the eight hop
# primitives over a mesh axis object (repro_torch/launch/mesh.py) in place
# of a named shard_map axis.
"""RBM hop primitives on a mesh axis — the LISA substrate, adapted.

The mapping (DESIGN.md Sec. 2):

  DRAM subarray            ->  device position on the axis
  RBM (adjacent buffers)   ->  ``axis.ppermute`` one-step shift
  RBM hop chain            ->  sequential single-pair ppermutes (linear cost)
  1-to-N via latching      ->  every intermediate device keeps a copy
  bank-level parallelism   ->  per-hop compute-overlap hook (``ring_scan``)

Every function takes tensors whose dim 0 holds the axis's LOCAL devices:
one on a :class:`~repro_torch.launch.mesh.GroupAxis` rank, all ``n`` on a
:class:`~repro_torch.launch.mesh.StackedAxis`.  A device's index comes from
``axis.index()`` (the reference's ``axis_index``); the reference's
``axis`` argument of ``ring_allgather`` (a tensor dim) is ``dim`` here,
as the mesh axis takes that name.  ``ring_allgather`` writes each arriving
shard into its output in place (the reference's
``dynamic_update_index_in_dim`` makes a new array each hop).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F


def _shift_perm(n: int, step: int = 1) -> list[tuple[int, int]]:
    return [(i, (i + step) % n) for i in range(n)]


def _per_device(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``(n_local,)`` mask shaped to broadcast over ``x``'s shards."""
    return mask.view((-1,) + (1,) * (x.dim() - 1))


def rbm_hop(x: torch.Tensor, axis, step: int = 1) -> torch.Tensor:
    """One RBM hop: every device's shard moves to its neighbor (+step)."""
    return axis.ppermute(x, _shift_perm(axis.size, step))


def lisa_copy(x: torch.Tensor, src: int, dst: int, axis,
              wraparound: bool = True) -> torch.Tensor:
    """Point-to-point shard movement via a neighbor-hop chain (LISA-RISC).

    After the call, device ``dst`` holds device ``src``'s shard; all other
    devices keep their own.  The schedule is ``hops`` sequential single-pair
    ppermutes, so cost is linear in hop count, exactly Table 1's structure.
    """
    n = axis.size
    if src == dst:
        return x
    fwd = (dst - src) % n
    if wraparound:
        # Ring: take the shorter direction.
        step, hops = ((-1, n - fwd) if (n - fwd) < fwd else (1, fwd))
    else:
        # Linear chain (no wrap links): the direct route is the only route.
        step, hops = ((1, dst - src) if dst >= src else (-1, src - dst))
    v = x
    cur = src
    for _ in range(hops):
        nxt = (cur + step) % n
        v = axis.ppermute(v, [(cur, nxt)])
        cur = nxt
    return torch.where(_per_device(axis.index() == dst, x), v, x)


def lisa_broadcast(x: torch.Tensor, src: int, axis,
                   dsts: Optional[Sequence[int]] = None) -> torch.Tensor:
    """1-to-N multicast with intermediate latching (paper Sec. 5.2).

    One hop chain from ``src`` to the farthest destination; *every* device
    the data passes through latches a copy.  ``dsts=None`` broadcasts to
    all.  Returns: on devices in ``dsts`` (and src) the source shard,
    elsewhere the device's own shard.
    """
    n = axis.size
    idx = axis.index()
    if dsts is None:
        dsts = [d for d in range(n) if d != src]
    want = axis.mask(list(dsts) + [src])

    # Walk both directions to the farthest requested destination.
    fwd_hops = max(((d - src) % n) for d in dsts)
    bwd_hops = max(((src - d) % n) for d in dsts)
    if fwd_hops + bwd_hops >= n:          # full ring: one direction suffices
        fwd_hops, bwd_hops = n - 1, 0

    latched = x
    got = idx == src
    for direction, hops in ((1, fwd_hops), (-1, bwd_hops)):
        v = x
        cur = src
        for _ in range(hops):
            nxt = (cur + direction) % n
            v = axis.ppermute(v, [(cur, nxt)])
            cur = nxt
            here = idx == cur
            latched = torch.where(_per_device(here, x), v, latched)
            got = got | here
    return torch.where(_per_device(want & got, x), latched, x)


def ring_scan(x: torch.Tensor, axis,
              fn: Callable[..., object], init, reverse: bool = False):
    """The compute-overlap hook (bank-level-parallelism analogue).

    Runs ``n`` steps; at step ``k`` each device holds the shard originally
    on device ``(idx -+ k) mod n`` and calls ``acc = fn(acc, shard, src)``
    (``src``: an ``(n_local,)`` tensor).  Step k+1's hop is posted before
    ``fn`` runs at step k and waited for after it, so on a GroupAxis the
    transfer overlaps fn's compute; on a StackedAxis it is one K2 launch
    queued ahead of fn's kernels.  ``n`` hops, the last one's result
    unused, as the reference's loop.
    """
    n = axis.size
    idx = axis.index()
    step = -1 if reverse else 1
    perm = _shift_perm(n, step)
    acc, buf = init, x
    for k in range(n):
        src = (idx - step * k) % n
        nxt = axis.ppermute_start(buf, perm)          # overlaps with fn
        acc = fn(acc, buf, src)
        buf = nxt.wait()
    return acc


def ring_allgather(x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
    """All-gather via an RBM hop ring: each device's shards concatenated
    in axis order along the shard's ``dim``."""
    n = axis.size
    local, shard = x.shape[0], tuple(x.shape[1:])
    rows = torch.arange(local, device=x.device)

    def take(acc, buf, src):
        acc[rows, src] = buf
        return acc

    out = ring_scan(x, axis, take,
                    torch.zeros((local, n) + shard, dtype=x.dtype,
                                device=x.device))
    if dim != 0:
        out = out.movedim(1, dim + 1)
        return out.reshape((local,) + shard[:dim] + (n * shard[dim],)
                           + shard[dim + 1:])
    return out.reshape((local, n * shard[0]) + shard[1:])


def ring_reduce_scatter(x: torch.Tensor, axis) -> torch.Tensor:
    """Reduce-scatter via a hop ring.  ``x``: (n, chunk...) per device;
    returns chunk ``idx`` summed across devices (n-1 hops), its adds in
    the reference's order."""
    n = axis.size
    idx = axis.index()
    rows = torch.arange(x.shape[0], device=x.device)
    perm = _shift_perm(n, 1)
    acc = x[rows, (idx - 1) % n]
    for t in range(1, n):
        acc = axis.ppermute(acc, perm)
        acc = acc + x[rows, (idx - t - 1) % n]
    return acc


def ring_allreduce(x: torch.Tensor, axis) -> torch.Tensor:
    """All-reduce = reduce-scatter + all-gather over the hop ring.

    2(n-1) hops each carrying 1/n of the payload — the bandwidth-optimal
    schedule, and structurally the paper's hop chain run twice (the
    all-gather's ring_scan posts one hop more, whose result it drops, as
    the reference's does: 2n - 1 on the axis's counter).
    """
    n = axis.size
    if n == 1:
        return x
    local = x.shape[0]
    flat = x.reshape(local, -1)
    size = flat.shape[1]
    flat = F.pad(flat, (0, (-size) % n))
    mine = ring_reduce_scatter(flat.reshape(local, n, -1), axis)
    full = ring_allgather(mine, axis)
    return full[:, :size].reshape(x.shape)


def ring_allgather_matmul(x: torch.Tensor, w: torch.Tensor, axis
                          ) -> torch.Tensor:
    """FSDP forward pattern with per-hop overlap: ``w`` is sharded on its
    *input* dim over the axis; computes ``x @ w_full`` without ever
    materialising ``w_full`` — each hop's shard is consumed by a partial
    matmul while the next hop is in flight.

    x: (local, ..., d) with d = n * d_shard;  w: (local, d_shard, f)
    ->  (local, ..., f).  The partial products are ``torch.matmul``, as
    the reference leaves them to XLA.
    """
    n = axis.size
    local, d_shard, f = w.shape
    lead = tuple(x.shape[1:-1])
    # (local, n, rows, d_shard): the slice of x each source's shard meets
    xs = x.reshape(local, -1, n, d_shard).movedim(2, 1)
    rows = torch.arange(local, device=x.device)

    def partial(acc, w_shard, src):
        return acc + xs[rows, src] @ w_shard

    init = torch.zeros((local, xs.shape[2], f),
                       dtype=torch.result_type(x, w), device=x.device)
    out = ring_scan(w, axis, partial, init)
    return out.reshape((local,) + lead + (f,))
