# Port of src/repro/serve/paged_store.py in torch.
"""Paged, dtype-preserving KV-snapshot layout for the serving engine.

A suspended session's KV cache is stored as fixed-size *pages* of raw bytes
(default 8x128 = 1 KB), bit-exact and without any float32 upcast.  The
staging itself is the movement substrate's paging layer
(:mod:`repro_torch.movement.paging`); this module is the serving-layer view of
it plus the session-store constructor.  The page pool lives in a
:class:`~repro_torch.core.lisa.villa_cache.TieredStore` whose items are page
blocks, moved by the page kernels.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core.dram.villa import VillaConfig
from repro_torch.core.lisa import villa_cache as VC
from repro_torch.fork import ForkPageTable
from repro_torch.movement.paging import (  # noqa: F401  (serving-layer re-exports)
    PageSpec,
    pack_slot,
    page_checksums,
    row_page_table,
    unpack_into_slot,
    verify_pages,
)


def make_session_store(spec: PageSpec, n_sessions: int, cfg: VillaConfig,
                       device=None) -> VC.TieredStore:
    """A VILLA tiered store over uint8 page blocks on ``device`` (default:
    cuda, raising without a GPU): the slow tier holds every session's
    pages; the fast tier caches hot (frequently resumed) ones."""
    slow = torch.zeros((n_sessions, spec.n_pages, spec.page_rows,
                        spec.page_lanes), dtype=torch.uint8,
                       device=resolve_device(device))
    return VC.make_store(slow, cfg)


def make_fork_table() -> ForkPageTable:
    """The store's CoW alias ledger (one per store/replica): logical uids
    -> physical slow-pool rows, refcounted so N forked sessions alias one
    row until a writer diverges."""
    return ForkPageTable()
