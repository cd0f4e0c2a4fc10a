# Port of src/repro/movement/backends.py:31-147 in torch, the mesh mode of
# the hop_chain leg (:106-121) over the axis objects of launch/mesh.py.
"""Default movement backends: the real-tensor layer of the substrate.

Registered on ``import repro_torch.movement``.  Each backend is the thinnest
adapter from a typed leg to the device work:

  pack_pages / unpack_pages  ->  repro_torch.movement.paging (uint8 views)
  page_gather / page_scatter ->  the CUDA page kernels K2 / K1
                                 (repro_torch.kernels.ops dispatch)
  page_alias                 ->  nothing (host bookkeeping, zero launches)
  tile_copy                  ->  the CUDA tile copy kernel K4
                                 (a new tensor; the source is not aliased)
  host_stage                 ->  device <-> host copies across the channel
  hop_chain                  ->  the identity in ``local_fabric`` mode (the
                                 single-process replica fleet); over a mesh
                                 axis, ``rbm.rbm_hop`` or ``rbm.lisa_copy``

A mesh env names its axes: ``axes={name: axis}`` (the objects of
:mod:`repro_torch.launch.mesh`), and a ``HopChainLeg`` runs over
``env["axes"][leg.axis]``.  In such an env every operand carries the
axis's local devices on dim 0: a pool is (local, P, ...), its table (T,)
for every device or (local, T), the payload (local, T, ...).  The page
legs then run ONE K2 (or K1) launch over the local devices' pools
flattened into one, each device's entries offset into its own pool (a
skipped gather entry reads zeros).  After a point-to-point chain only the
chain's destination lands the payload: the scatter skips every other
device's entries, as the pools are written in place (the reference's
devices each scatter into a functional copy, which its callers mask
away).

The VILLA tier legs (``tier_read`` / ``tier_write``) are registered by
:mod:`repro_torch.core.lisa.villa_cache`, which owns the caching policy.
Updates are IN PLACE: unpack writes the cache slot, page_scatter writes the
pool (the reference's donated buffers).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import to_device
from repro_torch.core.lisa import rbm
from repro_torch.kernels import ops
from repro_torch.kernels.ref import check_table
from repro_torch.movement import paging
from repro_torch.movement.plan import (HopChainLeg, Leg, PackLeg,
                                       TileCopyLeg, UnpackLeg)
from repro_torch.movement.registry import Env, register_backend


@register_backend("pack_pages")
def _pack_pages(leg: PackLeg, env: Env) -> Env:
    # Plural env keys declare a wave: every slot packs into one
    # (k, n_pages, P, d) buffer.
    env = dict(env)
    spec = leg.page_spec
    if leg.batch > 1 or "slots" in env:
        slots = list(env["slots"])
        dev = paging.cache_leaves(env["cache"])[0].device
        data = torch.empty((len(slots), spec.n_pages, spec.page_rows,
                            spec.page_lanes), dtype=torch.uint8, device=dev)
        for i, s in enumerate(slots):
            paging.pack_slot(spec, env["cache"], s, out=data[i])
        env["data"] = data
    else:
        env["data"] = paging.pack_slot(spec, env["cache"], env["slot"])
    # The detection sidecar: every pack leg emits per-page checksums
    # alongside the payload; device ops only, no host sync.
    env["sums"] = paging.page_checksums(env["data"])
    return env


@register_backend("unpack_pages")
def _unpack_pages(leg: UnpackLeg, env: Env) -> Env:
    env = dict(env)
    expected = env.get("sums")
    if expected is not None:
        # Verify at unpack against the checksums carried from pack time.
        # ``verify_fail`` counts ITEMS with any corrupt page and stays on
        # the device: the verdict rides the caller's existing sync.
        mismatch = paging.page_checksums(env["data"]) != expected
        if mismatch.dim() > 1:
            env["verify_fail"] = mismatch.any(dim=-1).sum().to(torch.int32)
        else:
            env["verify_fail"] = mismatch.any().to(torch.int32)
    if leg.batch > 1 or "slots" in env:
        for s, pages in zip(env["slots"], env["data"]):
            paging.unpack_into_slot(leg.page_spec, env["cache"], s, pages)
    else:
        paging.unpack_into_slot(leg.page_spec, env["cache"], env["slot"],
                                env["data"])
    return env


def _mesh_pages(pool: torch.Tensor, table, landing=None):
    """A mesh env's pools (local, P, ...) as one pool of local x P pages,
    and its table as one table over it: device l's entry e becomes
    ``l * P + e``; an entry outside ``[0, P)`` (a host table's raise
    first), or any entry of a device ``landing`` excludes, becomes -1, a
    skip, so no device reaches into another's pool."""
    if not pool.is_contiguous():
        raise ValueError("a mesh env's pool must be contiguous: the page "
                         "legs write it in place")
    local, n_pool = pool.shape[:2]
    if isinstance(table, torch.Tensor) and table.is_cuda:
        t = table.to(torch.int32)
    else:
        t = torch.as_tensor(table, dtype=torch.int32)
        check_table(t, n_pool)
        t = to_device(t, pool.device)
    if t.dim() == 1:
        t = t.expand(local, -1)
    keep = (t >= 0) & (t < n_pool)
    if landing is not None:
        keep = keep & landing[:, None]
    off = torch.arange(local, dtype=torch.int32, device=pool.device)
    flat = torch.where(keep, t + off[:, None] * n_pool, -1).reshape(-1)
    return pool.view((local * n_pool,) + tuple(pool.shape[2:])), flat


@register_backend("page_gather")
def _page_gather(leg, env: Env) -> Env:
    # ``out`` (optional): gather into an existing buffer, where -1 table
    # entries keep what it holds (the masked read of a tier access).
    env = dict(env)
    pool, table = env[leg.pool_key], env[leg.table_key]
    if "axes" in env:
        if env.get("out") is not None:
            raise ValueError("a mesh env's page gather takes no out buffer")
        flat, t = _mesh_pages(pool, table)
        # a skipped entry (-1, or outside its device's pool) reads zeros
        got = ops.villa_gather(flat, t, torch.zeros(
            (t.numel(),) + tuple(flat.shape[1:]), dtype=flat.dtype,
            device=flat.device))
        env["data"] = got.view((pool.shape[0], -1) + tuple(pool.shape[2:]))
        return env
    env["data"] = ops.villa_gather(pool, table, env.get("out"))
    return env


@register_backend("page_scatter")
def _page_scatter(leg, env: Env) -> Env:
    env = dict(env)
    pool, table, data = env[leg.pool_key], env[leg.table_key], env["data"]
    if "axes" in env:
        flat, t = _mesh_pages(pool, table, env.get("landing"))
        ops.villa_scatter(flat, t, data.reshape((-1,) + tuple(
            pool.shape[2:])))
        return env
    env[leg.pool_key] = ops.villa_scatter(pool, table, data)
    return env


@register_backend("tile_copy")
def _tile_copy(leg: TileCopyLeg, env: Env) -> Env:
    env = dict(env)
    env["data"] = ops.rbm_copy(env["data"], tile_rows=leg.tile_rows,
                               lanes=leg.lanes)
    return env


@register_backend("hop_chain")
def _hop_chain(leg: HopChainLeg, env: Env) -> Env:
    env = dict(env)
    if env.get("local_fabric"):
        # Single-process replica fleet (serve/cluster.py): the replica pools
        # share one address space, so the payload the gather leg staged is
        # already reachable by the scatter leg — the hop chain contributes
        # the PRICED mesh route (the plan's cost is the ICI hop model) and
        # is an identity on the bytes here.
        return env
    axes = env.get("axes") or {}
    if leg.axis not in axes:
        raise KeyError(f"hop_chain leg over axis {leg.axis!r}: the env's "
                       f"axes {sorted(axes)} do not name it (pass "
                       f"axes={{{leg.axis!r}: axis}}, or local_fabric=True "
                       f"in a single-process fleet)")
    axis = axes[leg.axis]
    if leg.src is None or leg.dst is None:
        env["data"] = rbm.rbm_hop(env["data"], axis, leg.step)
    else:
        env["data"] = rbm.lisa_copy(env["data"], leg.src, leg.dst, axis,
                                    wraparound=leg.wraparound)
        env["landing"] = axis.mask([leg.dst])
    return env


@register_backend("page_alias")
def _page_alias(leg: Leg, env: Env) -> Env:
    # Zero-copy fork fast path: the ForkPageTable repointed the child's
    # logical row on the host before this plan executed; no bytes move and
    # nothing is launched.
    return env


@register_backend("host_stage")
def _host_stage(leg: Leg, env: Env) -> Env:
    env = dict(env)
    leaves = env["data"]
    if leg.to_host:
        # tensors come back as numpy arrays; plain Python / numpy scalar
        # leaves (a checkpoint's step counters) pass through numpy
        env["data"] = [None if t is None else
                       t.detach().cpu().numpy()
                       if isinstance(t, torch.Tensor) else np.asarray(t)
                       for t in leaves]
    else:
        env["data"] = [None if a is None else
                       to_device(np.asarray(a), env["device"])
                       for a in leaves]
    return env
