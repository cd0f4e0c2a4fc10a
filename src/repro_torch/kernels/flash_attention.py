# Port of src/repro/kernels/flash_attention.py::flash_attention (:81-131) as
# the CUDA kernels of csrc/flash_attention.cu (prefill) and
# csrc/flash_decode.cu (decode), in the contract of
# src/repro/models/attention.py::chunked_attention (:37-126).
"""Launch wrapper of the attention kernels (K3) and the (B,H,S,D) layout
wrapper around them.

:func:`chunked_attention` launches the kernels on CUDA tensors in the
serving model's layout — q (B,S,H,D), k/v (B,T,K,D), per-row positions —
checks device, dtype, contiguity and shape, launches on
q's device's current stream, allocates its output with ``torch.empty``,
raises if the launch reports an error, and counts its calls in
``chunked_attention.launches``, one a launch, and by route in
``chunked_attention.prefill`` and ``chunked_attention.decode``.  Decode
(S = 1) runs the split-KV kernel, laid out by :func:`decode_plan`, with its
partials and tickets in a workspace kept per device and stream
(:func:`_workspace`).  Prefill (S > 1) runs the tensor-core kernel, laid
out by :func:`prefill_plan`.  q/k/v that do not start on a 16-byte
boundary, which both kernels' vector loads need, are copied first.  It
takes the reference's causal and sliding-window masks (``window > 0``, the
``attn_local`` layers), head dims 16, 32, 64, 128 and 256, and q in another
float dtype than k/v (bf16 weights over an f32 cache): the kernels read each
in its own dtype and promote as the reference does, so nothing is cast
here.  It raises ``NotImplementedError`` on Dv != Dk (MLA) and
``ValueError`` on another head_dim, on k and v of different dtypes and on
groups of more than 64 heads: ROADMAP Queue 2 lists them under K3.  int8
K/V, whose scales the reference passes here, has no entry yet.  CPU
tensors never reach it:
:mod:`repro_torch.kernels.ops` routes them to the plain chunked twin.

:func:`flash_attention` is the reference kernel's own signature: q
(B,H,S,D), k/v (B,K,T,D), q rows at the tail of the kv sequence
(``q_pos = i + T - S``).  It builds those positions and goes through the
same dispatch, so on the card it runs the same kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = None
_DECODE_LIB = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the split-KV decode kernel's layout (csrc/flash_decode.cu)
DECODE_CTAS_PER_SM = 4      # the grid aims at this many CTAs an SM
SPLIT_ALIGN = 16            # a split's length is a multiple of this
MAX_SPLITS = 512            # the most splits the kernel's combine takes
HEAD_DIMS = (16, 32, 64, 128, 256)   # the head dims both kernels take
# the prefill kernel's layout (csrc/flash_attention.cu, namespace pf)
PREFILL_ROWS = 128          # (query, head) rows a CTA: 8 warps of 16
PREFILL_KEYS = 64           # keys a K/V tile
PREFILL_STAGES = 2          # K/V tiles in flight (cp.async ring)
WIDE_D = 128                # above it two warps share a row block: 64 rows


def _lib() -> ctypes.CDLL:
    """The prefill kernel's library (``csrc/flash_attention.cu``), with
    its shared-memory opt-in."""
    global _LIB
    if _LIB is None:
        lib = _build.library("flash_attention")
        lib.flash_prefill_launch.argtypes = (
            [_P] * 6 + [_I] * 8 + [ctypes.c_float] + [_I] * 7 + [_P])
        lib.flash_attention_prepare.argtypes = []
        for fn in (lib.flash_prefill_launch, lib.flash_attention_prepare):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _decode_lib() -> ctypes.CDLL:
    """The split-KV decode kernel's library (``csrc/flash_decode.cu``)."""
    global _DECODE_LIB
    if _DECODE_LIB is None:
        lib = _build.library("flash_decode")
        lib.flash_decode_launch.argtypes = (
            [_P] * 8 + [_I] * 7 + [ctypes.c_float] + [_I] * 5 + [_P])
        lib.flash_decode_launch.restype = ctypes.c_int
        _DECODE_LIB = lib
    return _DECODE_LIB


@functools.lru_cache(maxsize=None)
def decode_plan(B: int, K: int, G: int, T: int, itemsize: int, n_sm: int,
                head_dim: int) -> Tuple[int, int, int, int]:
    """``(head_group, n_groups, n_split, split_len)`` of the split-KV
    decode kernel for B batch rows, K kv heads of G query heads each, T
    cache slots of ``itemsize``-byte elements (the cache's: q may be
    another dtype) and ``head_dim`` on ``n_sm`` SMs.

    A lane holds ``max(16 // itemsize, head_dim // 32)`` floats of a head's
    q and accumulator: one 16-byte K/V chunk of a row, or two at head dim
    256 in f32, where the 32 lanes of a warp share one row.  A CTA holds
    ``head_group`` query heads (2, 4 or 8: the smallest power of two >= G,
    at most 32 floats of q and of accumulator a lane, so 8 in f32 up to head
    dim 128, else 4), so a kv head needs ``n_groups`` CTAs.  The slots
    are cut into ``n_split`` contiguous splits of ``split_len`` (a multiple
    of SPLIT_ALIGN), enough that the grid ``n_split * K * n_groups * B``
    reaches DECODE_CTAS_PER_SM CTAs an SM where T allows, at most
    MAX_SPLITS; n_split = ceil(T / split_len), so no split is empty and
    there is at least one."""
    cap = 32 // max(16 // itemsize, head_dim // 32)
    head_group = min(cap, max(2, 1 << max(0, G - 1).bit_length()))
    n_groups = -(-G // head_group)
    want = min(MAX_SPLITS,
               -(-DECODE_CTAS_PER_SM * n_sm // max(1, B * K * n_groups)))
    per = -(-max(T, 1) // want)
    split_len = -(-per // SPLIT_ALIGN) * SPLIT_ALIGN
    return head_group, n_groups, -(-max(T, 1) // split_len), split_len


class PrefillPlan(NamedTuple):
    rows: int                    # (query, head) rows a CTA
    keys: int                    # keys a tile
    stages: int                  # tiles in flight
    bq: int                      # queries a CTA
    grid: Tuple[int, int, int]   # (query blocks, kv heads, batch rows)


@functools.lru_cache(maxsize=None)
def prefill_plan(B: int, S: int, H: int, K: int, head_dim: int,
                 f32: bool) -> PrefillPlan:
    """The prefill kernel's layout for q (B,S,H,D) over K kv heads: a CTA
    holds ``bq = rows // G`` queries of all G = H / K heads of one kv head
    (:func:`prefill_row`), and walks the keys in tiles of PREFILL_KEYS
    through a ring of ``stages``; the grid is one CTA per (query block, kv
    head, batch row).  ``rows`` is PREFILL_ROWS up to head dim WIDE_D and
    half that above it, where two warps share each 16-row block; there the
    f32 path (``f32``: q or K/V is f32) has one stage, since its Q and one
    K/V tile fill the CTA's shared memory."""
    wide = head_dim > WIDE_D
    rows = PREFILL_ROWS // 2 if wide else PREFILL_ROWS
    G = H // K
    if G < 1 or H % K or G > rows:
        raise ValueError(f"{H} heads over {K} kv heads: groups of 1 to "
                         f"{rows} heads only")
    bq = rows // G
    stages = 1 if wide and f32 else PREFILL_STAGES
    return PrefillPlan(rows, PREFILL_KEYS, stages, bq, (-(-S // bq), K, B))


def prefill_row(plan: PrefillPlan, S: int, G: int, qb: int, kvh: int,
                r: int) -> Tuple[int, int] | None:
    """``(query, head)`` of row ``r`` of the CTA of query block ``qb`` and kv
    head ``kvh``, as the kernel computes it, or None for a row it leaves
    empty."""
    s = qb * plan.bq + r // G
    if r >= plan.bq * G or s >= S:
        return None
    return s, kvh * G + r % G


@functools.lru_cache(maxsize=None)
def _device(index: int) -> int:
    """The SM count of CUDA device ``index``; on the first call for a
    device, also the prefill kernel's shared-memory opt-in there."""
    with torch.cuda.device(index):
        err = _lib().flash_attention_prepare()
    if err:
        raise RuntimeError(f"attention kernel opt-in failed: error {err}")
    return torch.cuda.get_device_properties(index).multi_processor_count


_WORKSPACE = {}


def _workspace(device: torch.device, stream: int, n_part: int,
               n_tickets: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode kernel's f32 partials and int32 tickets for one launch on
    ``stream``: kept per (device, stream) and grown on demand, since calls
    on one stream run in order.  Tickets start at 0, and the kernel leaves
    them at 0."""
    key = (device.index, stream)
    part, tickets = _WORKSPACE.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    _WORKSPACE[key] = part, tickets
    return part, tickets


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """K3 on the card.  q: (B,S,H,D), k/v: (B,T,K,D), q_pos (B,S) and
    kv_pos (B,T) int32; key t is valid for query s iff kv_pos <= q_pos
    (causal) and kv_pos > q_pos - window (window > 0).  q and k/v may
    differ in dtype, k and v may not.  Returns (B,S,H,D) in q's dtype."""
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
                    ("kv_pos", kv_pos)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise ValueError(f"q must be float32 or bfloat16 and k/v share "
                         f"float32 or bfloat16 (got {q.dtype}, {k.dtype}, "
                         f"{v.dtype})")
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if v.shape[-1] != D:
        raise NotImplementedError("Dv != Dk (MLA) arrives with its slice")
    if (tuple(k.shape) != (B, T, K, D) or tuple(v.shape) != (B, T, K, D)
            or H % K or tuple(q_pos.shape) != (B, S)
            or tuple(kv_pos.shape) != (B, T)):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} q_pos {tuple(q_pos.shape)} "
                         f"kv_pos {tuple(kv_pos.shape)} do not fit "
                         f"(B,S,H,D) / (B,T,K,D) with H % K == 0")
    if D not in HEAD_DIMS or H // K > 64:
        raise ValueError(f"head_dim {D} / group {H // K}: the kernel takes "
                         f"head_dim 16, 32, 64, 128 or 256 and groups of at "
                         f"most 64")
    q, k, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
               else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_pos = kv_pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    n_sm = _device(q.device.index)
    if S == 1:
        gc, groups, n_split, split_len = decode_plan(
            B, K, H // K, T, k.element_size(), n_sm, D)
        part, tickets = _workspace(q.device, stream,
                                   B * H * n_split * (D + 2), B * K * groups)
        err = _decode_lib().flash_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), B, T, H, K, D, int(causal), int(window),
            D ** -0.5, _DTYPES[q.dtype], _DTYPES[k.dtype], gc, n_split,
            split_len, stream)
    else:
        plan = prefill_plan(B, S, H, K, D, torch.float32 in (q.dtype,
                                                            k.dtype))
        err = _lib().flash_prefill_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), B, S, T, H, K, D, int(causal),
            int(window), D ** -0.5, _DTYPES[q.dtype], _DTYPES[k.dtype],
            plan.rows, plan.keys, plan.stages, plan.bq, plan.grid[0],
            stream)
    if err:
        raise RuntimeError(f"attention kernel launch failed: error {err}")
    chunked_attention.launches += 1
    if S == 1:
        chunked_attention.decode += 1
    else:
        chunked_attention.prefill += 1
    return out


chunked_attention.launches = 0
chunked_attention.prefill = 0
chunked_attention.decode = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,H,S,D); k/v: (B,K,T,D).  Returns (B,H,S,D)."""
    from repro_torch.kernels import ops

    B, H, S, D = q.shape
    T = k.shape[2]
    q_pos = (torch.arange(S, dtype=torch.int32, device=q.device)
             + (T - S)).expand(B, S)
    kv_pos = torch.arange(T, dtype=torch.int32, device=q.device).expand(B, T)
    out = ops.chunked_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), q_pos, kv_pos,
                                causal=causal, window=window)
    return out.transpose(1, 2)
