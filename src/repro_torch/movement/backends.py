# Port of src/repro/movement/backends.py:31-147 in torch.
"""Default movement backends: the real-tensor layer of the substrate.

Registered on ``import repro_torch.movement``.  Each backend is the thinnest
adapter from a typed leg to the device work:

  pack_pages / unpack_pages  ->  repro_torch.movement.paging (uint8 views)
  page_gather / page_scatter ->  the CUDA page kernels K2 / K1
                                 (repro_torch.kernels.ops dispatch)
  page_alias                 ->  nothing (host bookkeeping, zero launches)
  host_stage                 ->  device <-> host copies across the channel
  tile_copy, hop_chain       ->  NotImplementedError until their slices

The VILLA tier legs (``tier_read`` / ``tier_write``) are registered by
:mod:`repro_torch.core.lisa.villa_cache`, which owns the caching policy.
Updates are IN PLACE: unpack writes the cache slot, page_scatter writes the
pool (the reference's donated buffers).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.movement import paging
from repro_torch.movement.plan import Leg, PackLeg, UnpackLeg
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


@register_backend("page_gather")
def _page_gather(leg, env: Env) -> Env:
    # ``out`` (optional): gather into an existing buffer, where -1 table
    # entries keep what it holds (the masked read of a tier access).
    env = dict(env)
    env["data"] = ops.villa_gather(env[leg.pool_key], env[leg.table_key],
                                   env.get("out"))
    return env


@register_backend("page_scatter")
def _page_scatter(leg, env: Env) -> Env:
    env = dict(env)
    env[leg.pool_key] = ops.villa_scatter(env[leg.pool_key],
                                          env[leg.table_key], env["data"])
    return env


@register_backend("tile_copy")
def _tile_copy(leg: Leg, env: Env) -> Env:
    raise NotImplementedError(
        "tile_copy (the rbm_copy kernel, K4) is not ported yet: plan() emits "
        "it only for device->device transfers, which no serving path issues")


@register_backend("hop_chain")
def _hop_chain(leg: Leg, env: Env) -> Env:
    raise NotImplementedError(
        "hop_chain legs (mesh ppermute chains / the cluster's local fabric) "
        "arrive with the cluster and multi-device slices")


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
        env["data"] = [None if t is None else t.detach().cpu().numpy()
                       for t in leaves]
    else:
        device = env["device"]
        env["data"] = [None if a is None else
                       torch.as_tensor(np.asarray(a)).to(device)
                       for a in leaves]
    return env
