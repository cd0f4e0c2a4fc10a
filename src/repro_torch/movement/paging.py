# Port of src/repro/movement/paging.py:27-139 in torch.
"""Byte-paged, dtype-preserving layout staging for movement plans.

A snapshot of one slot of a batched cache is staged as fixed-size *pages* of
raw bytes (default 8x128 = 1 KB — one DRAM row in the paper's geometry).
Every leaf is reinterpreted as uint8 (``Tensor.view(torch.uint8)`` in place
of ``bitcast_convert_type``), so int8 stays 1 byte/elem and bf16 stays 2 —
no float32 upcast anywhere on a movement path, and restore is bit-exact.

Leaf order decides the page bytes and must be the reference's: JAX flattens
dicts in sorted-key order (``stage0/b0/{k, pos, v}``), and so does
:func:`cache_leaves`.

Slot indices are host ints: packing reads ``cache[:, slot]`` and unpacking
writes it IN PLACE (the port's counterpart of the reference's donated cache).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Tuple

import torch


def cache_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict in JAX's flatten order (sorted keys)."""
    if isinstance(tree, dict):
        out: List[torch.Tensor] = []
        for k in sorted(tree):
            out.extend(cache_leaves(tree[k]))
        return out
    return [tree]


def _byte_view(flat: torch.Tensor, off: int, shape: Tuple[int, ...],
               dtype: torch.dtype) -> torch.Tensor:
    """``flat[off:off+nbytes]`` (uint8) viewed as ``dtype`` of ``shape`` —
    no copy.  Leaf offsets are sums of whole leaves, so they stay aligned to
    the dtype on every cache the port builds (``view`` raises otherwise)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    seg = flat[off:off + math.prod(shape) * itemsize]
    return seg.view(dtype).view(shape)


@dataclasses.dataclass(frozen=True)
class PageSpec:
    """Static byte layout of one snapshot (one slot slice of a cache)."""
    leaf_shapes: Tuple[Tuple[int, ...], ...]
    leaf_dtypes: Tuple[Any, ...]
    leaf_offsets: Tuple[int, ...]       # byte offset of each leaf
    total_bytes: int                    # sum of leaf bytes (true, not upcast)
    page_rows: int = 8
    page_lanes: int = 128

    @property
    def page_bytes(self) -> int:
        return self.page_rows * self.page_lanes

    @property
    def n_pages(self) -> int:
        return -(-self.total_bytes // self.page_bytes)

    @classmethod
    def for_cache(cls, cache, *, page_rows: int = 8,
                  page_lanes: int = 128) -> "PageSpec":
        """Layout for one slot of a batched cache (leaves (reps, slots, ...))."""
        shapes, dtypes, offsets = [], [], []
        off = 0
        for leaf in cache_leaves(cache):
            shape = tuple(leaf.shape[:1]) + tuple(leaf.shape[2:])
            shapes.append(shape)
            dtypes.append(leaf.dtype)
            offsets.append(off)
            off += math.prod(shape) * leaf.element_size()
        return cls(tuple(shapes), tuple(dtypes), tuple(offsets), off,
                   page_rows, page_lanes)


def pack_slot(spec: PageSpec, cache, slot: int,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """Snapshot cache[:, slot] into (n_pages, P, d) uint8 pages.

    ``out`` (optional, (n_pages, P, d) uint8) is filled in place — a wave
    packs straight into its (k, n_pages, P, d) buffer."""
    leaves = cache_leaves(cache)
    dev = leaves[0].device
    if out is None:
        out = torch.empty((spec.n_pages, spec.page_rows, spec.page_lanes),
                          dtype=torch.uint8, device=dev)
    flat = out.view(-1)
    for leaf, shape, off in zip(leaves, spec.leaf_shapes, spec.leaf_offsets):
        _byte_view(flat, off, shape, leaf.dtype).copy_(leaf[:, slot])
    flat[spec.total_bytes:].zero_()
    return out


CHECKSUM_PAGES = 1 << 16     # pages a checksum pass widens at once


def page_checksums(pages: torch.Tensor) -> torch.Tensor:
    """Per-page position-weighted byte checksum, ``sum(byte[i] * (2*i + 1))
    mod 2^32`` — the reference's uint32 arithmetic, held in int64.

    ``pages`` is (..., P, d) uint8.  The weights are odd, hence units mod
    2^32, so ANY single-byte change is detected.  A page's sum is at most
    255 * (P*d)^2 (2.7e8 for 1 KB pages), so the int32 products and int64
    sum are exact and the final mask reproduces the wrap-around.  The bytes
    are widened CHECKSUM_PAGES pages at a time (64 MB of 1 KB pages), so a
    wave of GB-sized snapshots needs no int32 copy of its own size."""
    pb = pages.shape[-2] * pages.shape[-1]
    flat = pages.reshape(-1, pb)
    w = 2 * torch.arange(pb, dtype=torch.int32, device=pages.device) + 1
    sums = [torch.sum(flat[i:i + CHECKSUM_PAGES].to(torch.int32) * w,
                      dim=-1, dtype=torch.int64)
            for i in range(0, max(1, flat.shape[0]), CHECKSUM_PAGES)]
    out = sums[0] if len(sums) == 1 else torch.cat(sums)
    return (out & 0xFFFFFFFF).reshape(pages.shape[:-2])


def verify_pages(pages: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
    """Count of pages whose recomputed checksum mismatches ``sums`` (an
    int32 device scalar — no host sync)."""
    return torch.sum(page_checksums(pages) != sums).to(torch.int32)


def row_page_table(spec: PageSpec, row: int) -> torch.Tensor:
    """The flat-pool page table (a host tensor) addressing one store row's
    pages: ``row * n_pages + [0, n_pages)``.  Fork-aware callers pass the
    PHYSICAL row the fork table resolved."""
    return row * spec.n_pages + torch.arange(spec.n_pages, dtype=torch.int32)


def unpack_into_slot(spec: PageSpec, cache, slot: int,
                     pages: torch.Tensor):
    """Restore pages into cache[:, slot] IN PLACE; inverse of
    :func:`pack_slot`.  Returns ``cache``."""
    flat = pages.reshape(-1)
    for leaf, shape, dtype, off in zip(cache_leaves(cache), spec.leaf_shapes,
                                       spec.leaf_dtypes, spec.leaf_offsets):
        leaf[:, slot].copy_(_byte_view(flat, off, shape, dtype))
    return cache
