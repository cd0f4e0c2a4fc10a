# Port of src/repro/core/dram/villa.py:46-97 (villa_init, villa_epoch,
# villa_access) in torch.  The config is the reference's dataclass, copied.
"""LISA-VILLA: in-DRAM caching policy (paper Sec. 3.2.1), in torch.

The policy is the reference's, exactly:
  * a set of saturating counters tracks row accesses;
  * counter values are halved every epoch (staleness control);
  * at the end of an epoch the ``n_hot`` most-frequently-accessed rows are
    marked *hot* (every counter >= the n_hot-th value, so ties can mark
    more rows) and are cached into the fast tier on their next access;
  * replacement is *benefit-based*: every cached row has a benefit counter
    incremented on hit; the minimum-benefit row is evicted (the first
    minimum, as ``torch.argmin`` and ``jnp.argmin`` both take it).

Every function is a handful of device ops on small tensors and never syncs
with the host: the reference's epoch ``lax.cond`` is a device-side
``torch.where`` over the epoch-maintained state.  Row ids and the returned
``hit`` / ``insert`` / ``victim`` are 0-d device tensors.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch import resolve_device

COUNTER_SATURATION = 32767          # 15-bit saturating counters (6KB/bank, Sec 3.2.1 fn2)


@dataclasses.dataclass(frozen=True)
class VillaConfig:
    n_counters: int = 1024
    n_hot: int = 16                  # rows marked hot per epoch
    n_slots: int = 16                # rows the fast subarray can hold
    epoch_len: int = 256             # accesses per epoch (controller ticks it)
    # fast-subarray timings (short bitlines; TL-DRAM-like near segment), ns
    tRCD_fast: float = 7.5
    tRAS_fast: float = 18.0
    tRP_fast: float = 8.75
    tCL_fast: float = 13.75          # column path unchanged


class VillaState(NamedTuple):
    counters: torch.Tensor   # (n_counters,) int32, saturating
    hot: torch.Tensor        # (n_counters,) bool — marked hot last epoch
    tags: torch.Tensor       # (n_slots,) int32 cached row id, -1 empty
    benefit: torch.Tensor    # (n_slots,) int32
    tick: torch.Tensor       # () int32 — accesses since epoch start


def villa_init(cfg: VillaConfig, device=None) -> VillaState:
    """Empty policy state on ``device`` (default: cuda, raising without a
    GPU)."""
    device = resolve_device(device)
    return VillaState(
        counters=torch.zeros((cfg.n_counters,), dtype=torch.int32,
                             device=device),
        hot=torch.zeros((cfg.n_counters,), dtype=torch.bool, device=device),
        tags=torch.full((cfg.n_slots,), -1, dtype=torch.int32, device=device),
        benefit=torch.zeros((cfg.n_slots,), dtype=torch.int32, device=device),
        tick=torch.zeros((), dtype=torch.int32, device=device),
    )


def villa_epoch(state: VillaState, cfg: VillaConfig) -> VillaState:
    """End-of-epoch maintenance: halve counters, re-mark the top-n_hot."""
    topk_vals = torch.topk(state.counters, cfg.n_hot).values
    threshold = torch.clamp(topk_vals[-1], min=1)
    hot = state.counters >= threshold
    return state._replace(counters=torch.div(state.counters, 2,
                                             rounding_mode="floor"),
                          hot=hot, tick=torch.zeros_like(state.tick))


def villa_access(state: VillaState, row_id, cfg: VillaConfig
                 ) -> Tuple[VillaState, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """One access to ``row_id``.  Returns (state, hit, insert, victim_slot).

    ``hit``    — row is resident in the fast tier (bump its benefit).
    ``insert`` — row was marked hot and is not resident: cache it *now*,
                 evicting the minimum-benefit slot ``victim``.
    Epoch bookkeeping fires every ``epoch_len`` accesses.  The state is
    functional (new small tensors); no host sync anywhere.
    """
    dev = state.tags.device
    row = (row_id.to(device=dev, dtype=torch.int32)
           if isinstance(row_id, torch.Tensor) else
           torch.tensor(row_id, dtype=torch.int32, device=dev)).reshape(())
    cidx = torch.remainder(row, cfg.n_counters).reshape(1).long()
    bumped = torch.clamp(state.counters.index_select(0, cidx) + 1,
                         max=COUNTER_SATURATION)
    counters = state.counters.scatter(0, cidx, bumped)

    hit_mask = state.tags == row
    hit = hit_mask.any()
    benefit = torch.where(hit_mask, state.benefit + 1, state.benefit)

    is_hot = state.hot.index_select(0, cidx).reshape(())
    insert = is_hot & ~hit
    victim = torch.argmin(benefit).to(torch.int32)
    vidx = victim.reshape(1).long()
    tags = torch.where(insert, state.tags.scatter(0, vidx, row.reshape(1)),
                       state.tags)
    benefit = torch.where(insert, benefit.scatter(
        0, vidx, torch.ones(1, dtype=torch.int32, device=dev)), benefit)

    new = VillaState(counters=counters, hot=state.hot, tags=tags,
                     benefit=benefit, tick=state.tick + 1)
    ep = villa_epoch(new, cfg)
    fire = new.tick >= cfg.epoch_len
    new = VillaState(*(torch.where(fire, e, n) for e, n in zip(ep, new)))
    return new, hit, insert, victim
