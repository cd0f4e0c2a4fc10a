# Port of src/repro/core/lisa/villa_cache.py:37-225 in torch.
"""LISA-VILLA on the device: a tiered store with the paper's exact policy.

Hot *items* (suspended sessions' KV pages) are cached in a small fast pool
against a large slow pool; the policy (counters / epochs / hot marking /
benefit-based replacement) is :mod:`repro_torch.core.dram.villa`.  Every paged
read and write lowers through ``movement.plan`` to page gather/scatter legs
run by the page kernels K2/K1.

What differs from the reference, and why:

  * The pools are updated IN PLACE (the reference donates them): a
    :class:`TieredStore` returned by :func:`access` / :func:`write` shares
    the ``fast`` / ``slow`` tensors of the one passed in, with new policy
    state and counters.
  * The reference computes each conditional write and then selects with
    ``jnp.where`` over the whole pool.  Here the policy's outcomes
    (``hit``, ``insert``, ``victim``) stay on the device and become page
    tables whose entries are ``-1`` when the write or read must not
    happen: K1 skips them, so a masked write costs O(touched pages), and a
    masked read leaves the buffer it reads into as it was.  No ``.item()``
    and no Python ``if`` on a device value anywhere: a suspend or resume
    never waits for the device.
  * A wave (``access_many`` / ``write_many``) is a Python loop over items in
    order — the reference's ``lax.scan`` — with the same result.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import movement as MV
from repro_torch import to_device
from repro_torch.core.dram.villa import (VillaConfig, VillaState, villa_access,
                                         villa_init)


class TieredStore(NamedTuple):
    policy: VillaState
    fast: torch.Tensor      # (n_slots, *item_shape) — hot tier
    slow: torch.Tensor      # (n_items, *item_shape) — bulk tier
    hits: torch.Tensor      # () int32
    accesses: torch.Tensor  # () int32


@functools.lru_cache(maxsize=None)
def _pool_plan(direction: str, tier: str, spp: int, P: int, d: int,
               dtype_name: str) -> MV.MovementPlan:
    """One item's worth of raw page movement, planned once per pool shape
    ("read" -> a page-gather leg, "write" -> a page-scatter leg)."""
    layout = MV.Layout.raw_pages(spp, P, d, dtype_name)
    src, dst = ((tier, "compute") if direction == "read"
                else ("compute", tier))
    return MV.plan(MV.Transfer(MV.Tier(src), MV.Tier(dst), layout))


def _items(arr: torch.Tensor, item_ids) -> torch.Tensor:
    """Item ids as an int32 tensor on ``arr``'s device (host ids are copied
    without blocking; device ids are used as they are)."""
    if isinstance(item_ids, torch.Tensor):
        return item_ids.to(device=arr.device, dtype=torch.int32)
    return to_device(item_ids, arr.device, torch.int32)


def _item(arr: torch.Tensor, item_id) -> torch.Tensor:
    return _items(arr, item_id).reshape(())


def _table(item: torch.Tensor, spp: int) -> torch.Tensor:
    """Page table of one item's pages; all -1 (skip) when ``item < 0``."""
    t = item * spp + torch.arange(spp, dtype=torch.int32, device=item.device)
    return torch.where(item >= 0, t, torch.full_like(t, -1))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _read_item(arr: torch.Tensor, item_id, tier: str = "slow",
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Item ``item_id`` of ``arr``; with ``out``, read into it, and an
    ``item_id`` of -1 leaves ``out`` as it was."""
    n, spp, P, d = arr.shape
    p = _pool_plan("read", tier, spp, P, d, _dtype_name(arr.dtype))
    env = {"pool": arr.view(n * spp, P, d),
           "table": _table(_item(arr, item_id), spp)}
    if out is not None:
        env["out"] = out
    return MV.execute(p, **env)["data"]


def _write_item(arr: torch.Tensor, item_id, data: torch.Tensor,
                tier: str = "slow") -> torch.Tensor:
    """Write item ``item_id`` of ``arr`` IN PLACE; -1 writes nothing."""
    n, spp, P, d = arr.shape
    p = _pool_plan("write", tier, spp, P, d, _dtype_name(arr.dtype))
    MV.execute(p, pool=arr.view(n * spp, P, d),
               table=_table(_item(arr, item_id), spp), data=data)
    return arr


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True (0 if none), as int32, on the device."""
    return torch.argmax(mask.to(torch.int32)).to(torch.int32)


def make_store(slow: torch.Tensor, cfg: VillaConfig) -> TieredStore:
    """A store over ``slow`` (n_items, pages, P, d): items are page blocks,
    moved by the page kernels."""
    if slow.dim() != 4:
        raise ValueError(f"store items must be page blocks (n, pages, P, d); "
                         f"got {tuple(slow.shape)}")
    item_shape = tuple(slow.shape[1:])
    dev = slow.device
    return TieredStore(
        policy=villa_init(cfg, dev),
        fast=torch.zeros((cfg.n_slots,) + item_shape, dtype=slow.dtype,
                         device=dev),
        slow=slow,
        hits=torch.zeros((), dtype=torch.int32, device=dev),
        accesses=torch.zeros((), dtype=torch.int32, device=dev),
    )


def access(store: TieredStore, item_id, cfg: VillaConfig,
           out: Optional[torch.Tensor] = None
           ) -> Tuple[TieredStore, torch.Tensor, torch.Tensor]:
    """Read item ``item_id`` through the tiered store (into ``out`` if
    given).  Returns (store', data, hit).  Hot items are promoted on access,
    evicting the minimum-benefit slot: a masked slow->fast page scatter."""
    item = _item(store.slow, item_id)
    policy, hit, insert, victim = villa_access(store.policy, item, cfg)
    data = _read_item(store.slow, item, tier="slow", out=out)
    neg = torch.full_like(victim, -1)
    _write_item(store.fast, torch.where(insert, victim, neg), data,
                tier="fast")
    slot = _first(policy.tags == item)            # valid for hit & insert
    data = _read_item(store.fast, torch.where(hit, slot, neg), tier="fast",
                      out=data)
    return (TieredStore(policy=policy, fast=store.fast, slow=store.slow,
                        hits=store.hits + hit.to(torch.int32),
                        accesses=store.accesses + 1),
            data, hit)


def write(store: TieredStore, item_id, data: torch.Tensor) -> TieredStore:
    """Write-through: update the slow tier, and the fast slot if resident."""
    item = _item(store.slow, item_id)
    _write_item(store.slow, item, data, tier="slow")
    resident = store.policy.tags == item
    slot = torch.where(resident.any(), _first(resident),
                       torch.full_like(item, -1))
    _write_item(store.fast, slot, data, tier="fast")
    return store


def access_many(store: TieredStore, item_ids, cfg: VillaConfig
                ) -> Tuple[TieredStore, torch.Tensor, torch.Tensor]:
    """Batched :func:`access`: policy updates apply in ``item_ids`` order,
    exactly a loop of ``access`` calls.  Returns (store', data (k, *item),
    hits (k,))."""
    items = _items(store.slow, item_ids).reshape(-1)
    data = torch.empty((items.numel(),) + tuple(store.slow.shape[1:]),
                       dtype=store.slow.dtype, device=store.slow.device)
    hits = []
    for i in range(items.numel()):
        store, _, hit = access(store, items[i], cfg, out=data[i])
        hits.append(hit)
    return store, data, torch.stack(hits) if hits else torch.zeros(
        0, dtype=torch.bool, device=store.slow.device)


def write_many(store: TieredStore, item_ids, data: torch.Tensor
               ) -> TieredStore:
    """Batched :func:`write`, in order (later duplicates win)."""
    items = _items(store.slow, item_ids).reshape(-1)
    for i in range(items.numel()):
        store = write(store, items[i], data[i])
    return store


def clone_item(store: TieredStore, src_id, dst_id) -> TieredStore:
    """Device-side slow-row clone ``src_id -> dst_id`` (a shared-row
    demotion), through the same page gather/scatter plans as any other pool
    movement; any fast-tier residency of the DESTINATION row is dropped on
    the device."""
    src = _item(store.slow, src_id)
    dst = _item(store.slow, dst_id)
    data = _read_item(store.slow, src, tier="slow")
    _write_item(store.slow, dst, data, tier="slow")
    tags = store.policy.tags
    tags = torch.where(tags == dst, torch.full_like(tags, -1), tags)
    return store._replace(policy=store.policy._replace(tags=tags))


def hit_rate(store: TieredStore) -> torch.Tensor:
    return torch.where(store.accesses > 0,
                       store.hits / torch.clamp(store.accesses, min=1),
                       torch.zeros((), device=store.hits.device))


# ---------------------------------------------------------------------------
# Movement-registry integration: the policy-mediated tier legs.
# ---------------------------------------------------------------------------

@MV.register_backend("tier_read")
def _tier_read_backend(leg: MV.TierReadLeg, env: MV.Env) -> MV.Env:
    # Plural env keys declare a wave, so a batch-1 fused plan (one-element
    # resume wave) still routes through the batched path.
    env = dict(env)
    if leg.batch > 1 or "items" in env:
        env["store"], env["data"], env["hits"] = access_many(
            env["store"], env["items"], leg.policy)
    else:
        env["store"], env["data"], env["hit"] = access(
            env["store"], env["item"], leg.policy)
    return env


@MV.register_backend("tier_write")
def _tier_write_backend(leg: MV.TierWriteLeg, env: MV.Env) -> MV.Env:
    env = dict(env)
    if leg.batch > 1 or "items" in env:
        env["store"] = write_many(env["store"], env["items"], env["data"])
    else:
        env["store"] = write(env["store"], env["item"], env["data"])
    return env
