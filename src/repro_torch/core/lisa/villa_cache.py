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
  * A wave (``access_many`` / ``write_many``) is one movement dispatch,
    as the reference's ``lax.scan`` is one jitted dispatch: the policy
    runs item by item in order (small device ops), and the wave's pages
    move in as many launches as one item's (a write: one K1 into the slow
    pool, one into the fast; a read: one K2 from the slow pool, one from
    the fast, one K1 for the insertions), however wide the wave, with the
    result of a loop of single accesses.
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


def _table(items: torch.Tensor, spp: int) -> torch.Tensor:
    """Page table of the pages of each item in ``items`` (0-d or 1-d), in
    order; an item's entries are all -1 (skip) when it is ``< 0``."""
    items = items.reshape(-1, 1)
    t = items * spp + torch.arange(spp, dtype=torch.int32,
                                   device=items.device)
    return torch.where(items >= 0, t, torch.full_like(t, -1)).reshape(-1)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _read_item(arr: torch.Tensor, item_id, tier: str = "slow",
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Item ``item_id`` of ``arr`` (a 1-d ``item_id``: those items, stacked;
    ONE page gather either way); with ``out``, read into it, and an item of
    -1 leaves its part of ``out`` as it was."""
    n, spp, P, d = arr.shape
    items = _items(arr, item_id)
    p = _pool_plan("read", tier, items.numel() * spp, P, d,
                   _dtype_name(arr.dtype))
    env = {"pool": arr.view(n * spp, P, d), "table": _table(items, spp)}
    if out is not None:
        env["out"] = out.view(-1, P, d)
    data = MV.execute(p, **env)["data"]
    shape = ((items.numel(),) if items.dim() else ()) + (spp, P, d)
    return data.view(shape) if out is None else out


def _write_item(arr: torch.Tensor, item_id, data: torch.Tensor,
                tier: str = "slow") -> torch.Tensor:
    """Write item ``item_id`` of ``arr`` IN PLACE (a 1-d ``item_id``: each
    item its row of ``data``, later duplicates winning; ONE page scatter
    either way); an item of -1 writes nothing."""
    n, spp, P, d = arr.shape
    items = _items(arr, item_id)
    p = _pool_plan("write", tier, items.numel() * spp, P, d,
                   _dtype_name(arr.dtype))
    MV.execute(p, pool=arr.view(n * spp, P, d), table=_table(items, spp),
               data=data.reshape(-1, P, d))
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
    """Batched :func:`access`, with the result of a loop of ``access``
    calls in ``item_ids`` order.  Returns (store', data (k, *item), hits
    (k,)).

    The policy runs item by item; the pages move once for the wave: every
    item's slow pages (one K2), then the resident items' fast pages over
    them (one masked K2), then the insertions (one K1).  The fast reads
    come before the wave's insertions, so each reads what the loop's
    would: another item's insertion later in the wave cannot have reached
    it yet, and an item re-read after the wave itself inserted it (a
    duplicate) keeps its slow pages, which that insertion copied."""
    items = _items(store.slow, item_ids).reshape(-1)
    k = items.numel()
    if k == 0:
        return store, torch.empty((0,) + tuple(store.slow.shape[1:]),
                                  dtype=store.slow.dtype,
                                  device=store.slow.device), torch.zeros(
            0, dtype=torch.bool, device=store.slow.device)
    policy = store.policy
    hits, inserts, victims, slots = [], [], [], []
    for i in range(k):
        policy, hit, insert, victim = villa_access(policy, items[i], cfg)
        hits.append(hit)
        inserts.append(insert)
        victims.append(victim)
        slots.append(_first(policy.tags == items[i]))
    hit, insert = torch.stack(hits), torch.stack(inserts)
    victim, slot = torch.stack(victims), torch.stack(slots)
    neg = torch.full_like(victim, -1)
    # filled[j]: an earlier item of the wave inserted into j's slot
    earlier = torch.ones((k, k), dtype=torch.bool,
                         device=items.device).tril(-1)
    filled = ((insert[None, :] & (victim[None, :] == slot[:, None])
               & earlier).any(dim=1))
    data = _read_item(store.slow, items, tier="slow")
    _read_item(store.fast, torch.where(hit & ~filled, slot, neg),
               tier="fast", out=data)
    _write_item(store.fast, torch.where(insert, victim, neg), data,
                tier="fast")
    return (TieredStore(policy=policy, fast=store.fast, slow=store.slow,
                        hits=store.hits + hit.sum(dtype=torch.int32),
                        accesses=store.accesses + k),
            data, hit)


def write_many(store: TieredStore, item_ids, data: torch.Tensor
               ) -> TieredStore:
    """Batched :func:`write`, in order (later duplicates win): one K1 into
    the slow pool and one into the fast slots of the resident items, as
    wide as the wave."""
    items = _items(store.slow, item_ids).reshape(-1)
    if items.numel() == 0:
        return store
    _write_item(store.slow, items, data, tier="slow")
    resident = store.policy.tags[None, :] == items[:, None]
    slot = torch.where(resident.any(dim=1),
                       torch.argmax(resident.to(torch.int32), dim=1).to(
                           torch.int32), torch.full_like(items, -1))
    _write_item(store.fast, slot, data, tier="fast")
    return store


def update_in_place(store: TieredStore, new: TieredStore) -> TieredStore:
    """Write ``new``'s policy state and counters into ``store``'s own
    tensors and return ``store``: the state a resume updates stays in the
    tensors it had, as the reference's donated store does (``new`` shares
    ``store``'s pools already)."""
    if new.fast is not store.fast or new.slow is not store.slow:
        raise ValueError("update_in_place takes a store and its own "
                         "successor: the pools must be the same tensors")
    for old, cur in zip(tuple(store.policy) + (store.hits, store.accesses),
                        tuple(new.policy) + (new.hits, new.accesses)):
        if cur is not old:
            old.copy_(cur)
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
