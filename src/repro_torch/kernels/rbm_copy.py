# Port of src/repro/kernels/rbm_copy.py: villa_gather (:58-84) and
# villa_scatter (:93-122) as the CUDA kernels of csrc/page_copy.cu, rbm_copy
# (:27-49, the tile_copy leg) as the CUDA kernel of csrc/rbm_copy.cu.
"""Launch wrappers of the copy kernels (K1 ``villa_scatter``, K2
``villa_gather``, K4 ``rbm_copy``) on CUDA tensors.

Each wrapper checks device, dtype, contiguity and shape, launches on
the device's current stream, allocates what it returns with
``torch.empty``, raises if the launch reports an error, and counts its
launches in a plain integer attribute (``villa_gather.launches``), which a
run resets and reads to show which kernels its path went through.  They take
CUDA tensors only; :mod:`repro_torch.kernels.ops` routes CPU tensors to the
plain versions in :mod:`repro_torch.kernels.ref`.

A page table may be a host sequence or CPU tensor (range-checked on the
host, then copied to the card) or an int32 CUDA tensor computed on the
device (e.g. from the VILLA policy's outcomes), which cannot be checked
without a sync: the kernels skip every entry outside ``[0, N)`` instead, so
``-1`` is a skip and nothing out of range is ever touched.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Tuple

import torch

from repro_torch import to_device
from repro_torch.kernels import _build
from repro_torch.kernels.ref import check_copy_args, check_table

_P = ctypes.c_void_p
_I, _L = ctypes.c_int, ctypes.c_longlong
# argtypes of each C entry point, by source file in csrc/
_SIGNATURES = {
    "page_copy": {
        "villa_gather_grid": [_P],
        "villa_gather_launch": [_P, _P, _P, _I, _L, _I, _I, _P],
        "villa_scatter_launch": [_P, _P, _P, _I, _L, _I, _P, _P, _I, _P]},
    "rbm_copy": {"rbm_copy_grid": [_P], "rbm_copy_chunk": [],
                 "rbm_copy_launch": [_P, _P, _L, _I, _P]},
}
_LIBS = {}


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        lib = _build.library(name)
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def _check_pool(name: str, t: torch.Tensor) -> int:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if not t.is_contiguous() or t.dim() < 2:
        raise ValueError(f"{name} must be a contiguous (N, ...) page array")
    page_bytes = math.prod(t.shape[1:]) * t.element_size()
    if page_bytes % 16 or t.data_ptr() % 16:
        raise ValueError(f"{name}: pages must be 16-byte sized and aligned "
                         f"(page of {page_bytes} bytes)")
    return page_bytes


def device_table(table, n_pool: int, device: torch.device) -> torch.Tensor:
    """The page table as a contiguous int32 tensor on ``device``.  A host
    table is range-checked here (entries in ``[-1, n_pool)``)."""
    if isinstance(table, torch.Tensor) and table.is_cuda:
        if table.dtype != torch.int32 or table.dim() != 1:
            raise ValueError("a device page table must be 1-d int32")
        return table.contiguous()
    host = torch.as_tensor(table, dtype=torch.int32).reshape(-1)
    check_table(host, n_pool)
    return to_device(host, device)


def _stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream (without building a
    ``torch.cuda.Stream``, which costs the wrapper microseconds a call)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


# K2's work split (csrc/page_copy.cu): a copy unit is at most UNIT_VECS
# 16-byte vectors of a page; a CTA holds GATHER_WARPS warps, each moving
# the live units of a batch of 32 through two halves of HALF_BYTES
UNIT_VECS = 512
GATHER_WARPS = 6
HALF_BYTES = 16384


class GatherPlan(NamedTuple):
    page_vecs: int      # 16-byte vectors a page
    unit_vecs: int      # vectors a unit (the last unit of a page may be less)
    spp: int            # units a page
    n_units: int
    n_batches: int      # batches of 32 units, one table load a lane
    per_half: int       # units a half-buffer holds
    blocks: int         # CTAs launched


def gather_plan(n: int, page_bytes: int, grid: int) -> GatherPlan:
    """K2's split of ``n`` pages of ``page_bytes`` over at most ``grid``
    CTAs, as ``villa_gather_launch`` computes it."""
    page_vecs = page_bytes // 16
    unit_vecs = min(page_vecs, UNIT_VECS)
    spp = -(-page_vecs // unit_vecs)
    n_units = n * spp
    n_batches = -(-n_units // 32)
    return GatherPlan(page_vecs, unit_vecs, spp, n_units, n_batches,
                      min(32, HALF_BYTES // (16 * unit_vecs)),
                      min(grid, -(-n_batches // GATHER_WARPS)))


def gather_copies(table, n_pool: int, page_bytes: int, grid: int
                  ) -> List[Tuple[int, int, int]]:
    """``(warp, source vector, destination vector)`` of every 16-byte
    vector K2 moves for ``table``, by the kernel's own index math: warp w
    (CTA-fastest numbering) takes batches w, w + warps, ...; a batch's
    lanes each read one unit's entry, a ballot keeps those in [0, n_pool)
    in lane order, and each fill of a half-buffer gives lane i the live
    unit g0 + i, which it moves whole.  A host model for the tests; the
    card runs the kernel."""
    table = [int(e) for e in table]
    p = gather_plan(len(table), page_bytes, grid)
    warps = p.blocks * GATHER_WARPS
    copies = []
    for w in range(warps):
        for b in range(w, p.n_batches, warps):
            live = []
            for lane in range(32):
                u = b * 32 + lane
                if u >= p.n_units:
                    continue
                j, part = divmod(u, p.spp)
                if 0 <= table[j] < n_pool:
                    off = part * p.unit_vecs
                    live.append((table[j] * p.page_vecs + off,
                                 j * p.page_vecs + off,
                                 min(p.unit_vecs, p.page_vecs - off)))
            for g0 in range(0, len(live), p.per_half):
                for lane in range(min(p.per_half, len(live) - g0)):
                    src, dst, n = live[g0 + lane]
                    copies.extend((w, src + i, dst + i) for i in range(n))
    return copies


@functools.lru_cache(maxsize=None)
def _gather_grid(index: int) -> int:
    """K2's persistent grid on CUDA device ``index``, read once a device
    (the query also opts the kernel in to its shared memory there)."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _lib("page_copy").villa_gather_grid(ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"villa_gather grid query failed: cudaError {err}")
    return blocks.value


def villa_gather(pages: torch.Tensor, table, out: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """K2: out[j] = pages[table[j]].  With ``out`` given, entries of -1
    leave ``out[j]`` untouched (a masked read into an existing buffer)."""
    page_bytes = _check_pool("pages", pages)
    t = device_table(table, pages.shape[0], pages.device)
    n = t.numel()
    if out is None:
        out = torch.empty((n,) + tuple(pages.shape[1:]), dtype=pages.dtype,
                          device=pages.device)
    elif (tuple(out.shape) != (n,) + tuple(pages.shape[1:])
          or out.dtype != pages.dtype):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} does not match "
                         f"{n} pages of {tuple(pages.shape[1:])} {pages.dtype}")
    if n == 0:
        return out
    _check_pool("out", out)
    err = _lib("page_copy").villa_gather_launch(
        pages.data_ptr(), out.data_ptr(), t.data_ptr(), n, pages.shape[0],
        page_bytes, _gather_grid(pages.device.index), _stream(pages.device))
    if err:
        raise RuntimeError(f"villa_gather launch failed: cudaError {err}")
    villa_gather.launches += 1
    return out


villa_gather.launches = 0


def villa_scatter(pages: torch.Tensor, table, updates: torch.Tensor
                  ) -> torch.Tensor:
    """K1: pages[table[j]] = updates[j] IN PLACE (the reference's donated
    pool).  Entries of -1 are skipped; of duplicate entries the last wins.
    Returns ``pages``."""
    page_bytes = _check_pool("pages", pages)
    t = device_table(table, pages.shape[0], pages.device)
    n = t.numel()
    if (tuple(updates.shape) != (n,) + tuple(pages.shape[1:])
            or updates.dtype != pages.dtype):
        raise ValueError(f"updates {tuple(updates.shape)} {updates.dtype} do "
                         f"not match {n} pages of {tuple(pages.shape[1:])} "
                         f"{pages.dtype}")
    if n == 0:
        return pages
    _check_pool("updates", updates)
    cap = 1 << max(1, (2 * n - 1).bit_length())
    scratch = torch.full((2, cap), -1, dtype=torch.int32, device=pages.device)
    err = _lib("page_copy").villa_scatter_launch(
        pages.data_ptr(), updates.data_ptr(), t.data_ptr(), n, pages.shape[0],
        page_bytes, scratch[0].data_ptr(), scratch[1].data_ptr(), cap,
        _stream(pages.device))
    if err:
        raise RuntimeError(f"villa_scatter launch failed: cudaError {err}")
    villa_scatter.launches += 1
    return pages


villa_scatter.launches = 0


_COPY = {}           # device index -> (bound launch function, grid)


def _copy_launcher(index: int):
    """K4's launch function and persistent grid on CUDA device ``index``,
    read once a device (the grid query also opts the kernel in to its
    shared memory there)."""
    got = _COPY.get(index)
    if got is None:
        lib = _lib("rbm_copy")
        blocks = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = lib.rbm_copy_grid(ctypes.byref(blocks))
        if err:
            raise RuntimeError(f"rbm_copy grid query failed: cudaError {err}")
        got = _COPY[index] = (lib.rbm_copy_launch, blocks.value)
    return got


def rbm_copy(x: torch.Tensor, *, tile_rows: int = 256, lanes: int = 128
             ) -> torch.Tensor:
    """K4: a new tensor of ``x``'s shape and dtype holding every byte of
    ``x``.  The reference's ``(tile_rows, lanes)`` tiles are checked, but the
    kernel streams the bytes in its own chunks (``rbm_copy_chunk`` in
    csrc/rbm_copy.cu) through a persistent grid.  ``x`` must be contiguous: a strided view would need a
    second copy first, which would hide a library copy behind this kernel."""
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor (got {x.device})")
    check_copy_args(x, tile_rows, lanes)
    out = torch.empty_like(x)
    nbytes = x.nbytes
    if nbytes == 0:
        return out
    index = x.get_device()
    launch, grid = _copy_launcher(index)
    err = launch(x.data_ptr(), out.data_ptr(), nbytes, grid,
                 torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"rbm_copy launch failed: cudaError {err}")
    rbm_copy.launches += 1
    return out


rbm_copy.launches = 0
