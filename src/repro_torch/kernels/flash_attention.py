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
here.  On the prefill route it also takes Dk 192 / Dv 128 (MLA's expanded
K and V), with q and k/v both f32 or both bf16.  It raises
``NotImplementedError`` on Dv != Dk in decode (S = 1: no path launches it,
MLA decodes through its absorbed einsums) and ``ValueError`` on another
pair of head dims, on k and v of different dtypes, on mixed dtypes at
Dv != Dk and on groups of more than 64 heads: ROADMAP Queue 2 lists them
under K3.  int8 K/V come with the reference's per-token, per-head f32
scales, ``k_scale``/``v_scale`` (B,T,K), on the decode route (K3d): the
decode kernel dequantises each key and value as it loads them, for the (q
dtype, head dim, head group) triples of :data:`INT8_DECODE`, the ones the
int8 decode paths launch, and counts them in
``chunked_attention.decode_int8`` too.  int8 at S > 1 raises
``NotImplementedError`` (K3d's prefill: the reference cannot prefill an
int8 cache, so no path reaches it), another triple ``ValueError``.  CPU
tensors never reach it:
:mod:`repro_torch.kernels.ops` routes them to the plain chunked twin.

:func:`flash_attention` is the reference kernel's own signature: q
(B,H,S,D), k/v (B,K,T,D), q rows at the tail of the kv sequence
(``q_pos = i + T - S``).  It builds those positions and goes through the
same dispatch, so on the card it runs the same kernels.

:func:`train_attention` (K3e) is the prefill kernel under autograd, for
the training forward: ``kernels/ops.py`` takes it where grad is enabled
and q, k or v requires grad.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.scales import check_scales

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = None
_DECODE_LIB = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {**_DTYPES, torch.int8: 2}
# (q dtype, head dim, head group) of the int8 decode instantiations
# (csrc/flash_decode.cu): tinyllama, gemma3's ring and global layers and
# jamba's attention layers, f32 q
INT8_DECODE = ((torch.float32, 64, 8), (torch.float32, 128, 2),
               (torch.float32, 128, 4))
# the split-KV decode kernel's layout (csrc/flash_decode.cu)
DECODE_CTAS_PER_SM = 4      # the grid aims at this many CTAs an SM
SPLIT_ALIGN = 16            # a split's length is a multiple of this
MAX_SPLITS = 512            # the most splits the kernel's combine takes
HEAD_DIMS = (16, 32, 64, 128, 256)   # the head dims both kernels take
MLA_DIMS = (192, 128)       # (Dk, Dv) the prefill kernel also takes
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
            [_P] * 6 + [_I] * 9 + [ctypes.c_float] + [_I] * 7 + [_P])
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
            [_P] * 10 + [_I] * 7 + [ctypes.c_float] + [_I] * 5 + [_P])
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

    A lane holds ``max(vec, head_dim // 32)`` floats of a head's q and
    accumulator, ``vec`` the values of one load: a 16-byte K/V chunk of a
    row (``16 // itemsize``), or 4 int8 values (4 bytes) for an int8
    cache; two loads at head dim 256 in f32, where the 32 lanes of a warp
    share one row.  A CTA holds
    ``head_group`` query heads (2, 4 or 8: the smallest power of two >= G,
    at most 32 floats of q and of accumulator a lane, so 8 in f32 up to head
    dim 128, else 4), so a kv head needs ``n_groups`` CTAs.  The slots
    are cut into ``n_split`` contiguous splits of ``split_len`` (a multiple
    of SPLIT_ALIGN), enough that the grid ``n_split * K * n_groups * B``
    reaches DECODE_CTAS_PER_SM CTAs an SM where T allows, at most
    MAX_SPLITS; n_split = ceil(T / split_len), so no split is empty and
    there is at least one."""
    vec = 4 if itemsize == 1 else 16 // itemsize
    cap = 32 // max(vec, head_dim // 32)
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
                 f32: bool, v_dim: int) -> PrefillPlan:
    """The prefill kernel's layout for q (B,S,H,Dk) over K kv heads, Dk =
    ``head_dim`` and Dv = ``v_dim``: a CTA
    holds ``bq = rows // G`` queries of all G = H / K heads of one kv head
    (:func:`prefill_row`), and walks the keys in tiles of PREFILL_KEYS
    through a ring of ``stages``; the grid is one CTA per (query block, kv
    head, batch row).  ``rows`` is PREFILL_ROWS up to Dv = WIDE_D and half
    that above it, where two warps share each 16-row block.  Above Dk =
    WIDE_D the f32 path (``f32``: q or K/V is f32) has one stage, since its
    Q and one K/V tile fill the CTA's shared memory."""
    rows = PREFILL_ROWS // 2 if v_dim > WIDE_D else PREFILL_ROWS
    G = H // K
    if G < 1 or H % K or G > rows:
        raise ValueError(f"{H} heads over {K} kv heads: groups of 1 to "
                         f"{rows} heads only")
    bq = rows // G
    stages = 1 if head_dim > WIDE_D and f32 else PREFILL_STAGES
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
                      causal: bool = True, window: int = 0,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 on the card.  q: (B,S,H,Dk), k: (B,T,K,Dk), v: (B,T,K,Dv),
    q_pos (B,S) and kv_pos (B,T) int32; key t is valid for query s iff
    kv_pos <= q_pos (causal) and kv_pos > q_pos - window (window > 0).  q
    and k/v may differ in dtype where Dk = Dv, k and v may not.  int8 k/v
    take ``k_scale``/``v_scale`` (B,T,K) f32 (K3d, decode only).  Returns
    (B,S,H,Dv) in q's dtype."""
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
                    ("kv_pos", kv_pos), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if t is not None and not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if (q.dtype not in _DTYPES or k.dtype not in _KV_DTYPES
            or v.dtype != k.dtype):
        raise ValueError(f"q must be float32 or bfloat16 and k/v share "
                         f"float32, bfloat16 or int8 (got {q.dtype}, "
                         f"{k.dtype}, {v.dtype})")
    check_scales(k, k_scale, v_scale)
    B, S, H, D = q.shape
    T, K, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if (tuple(k.shape) != (B, T, K, D) or tuple(v.shape) != (B, T, K, Dv)
            or H % K or tuple(q_pos.shape) != (B, S)
            or tuple(kv_pos.shape) != (B, T)):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} q_pos {tuple(q_pos.shape)} "
                         f"kv_pos {tuple(kv_pos.shape)} do not fit "
                         f"(B,S,H,Dk) / (B,T,K,Dk) / (B,T,K,Dv) with "
                         f"H % K == 0")
    if H // K > 64 or ((D, Dv) != MLA_DIMS and
                       (D != Dv or D not in HEAD_DIMS)):
        raise ValueError(f"head_dim {D} / {Dv} / group {H // K}: the kernel "
                         f"takes head_dim 16, 32, 64, 128 or 256 for q, k "
                         f"and v, or Dk 192 / Dv 128 in prefill, and groups "
                         f"of at most 64")
    if D != Dv and S == 1:
        raise NotImplementedError(
            f"Dv != Dk ({D} / {Dv}) in decode (S = 1) is not ported: ROADMAP "
            f"Queue 2 K3c (MLA decodes through its absorbed einsums)")
    if D != Dv and q.dtype != k.dtype:
        raise ValueError(f"Dk {D} / Dv {Dv} takes q and k/v of one dtype "
                         f"(got {q.dtype} and {k.dtype})")
    int8 = k.dtype == torch.int8
    if int8 and S != 1:
        raise NotImplementedError(
            f"int8 K/V at S = {S} is not ported: ROADMAP Queue 2 K3d "
            f"(prefill; the reference cannot prefill an int8 cache)")
    n_sm = _device(q.device.index)
    if S == 1:
        gc, groups, n_split, split_len = decode_plan(
            B, K, H // K, T, k.element_size(), n_sm, D)
        if int8 and (q.dtype, D, gc) not in INT8_DECODE:
            raise ValueError(
                f"int8 K/V decode at q {q.dtype}, head_dim {D}, head group "
                f"{gc} (G {H // K}) is not instantiated: the kernel takes "
                f"{INT8_DECODE} (ROADMAP Queue 2 K3d)")
    q, k, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
               else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    if int8:
        k_scale = k_scale.to(torch.float32).contiguous()
        v_scale = v_scale.to(torch.float32).contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_pos = kv_pos.to(torch.int32).contiguous()
    out = q.new_empty((B, S, H, Dv))
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    if S == 1:
        part, tickets = _workspace(q.device, stream,
                                   B * H * n_split * (D + 2), B * K * groups)
        err = _decode_lib().flash_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if int8 else None,
            v_scale.data_ptr() if int8 else None, q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), B, T, H, K, D, int(causal), int(window),
            D ** -0.5, _DTYPES[q.dtype], _KV_DTYPES[k.dtype], gc, n_split,
            split_len, stream)
    else:
        plan = prefill_plan(B, S, H, K, D,
                            torch.float32 in (q.dtype, k.dtype), Dv)
        err = _lib().flash_prefill_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), B, S, T, H, K, D, Dv,
            int(causal), int(window), D ** -0.5, _DTYPES[q.dtype],
            _DTYPES[k.dtype], plan.rows, plan.keys, plan.stages, plan.bq,
            plan.grid[0], stream)
    if err:
        raise RuntimeError(f"attention kernel launch failed: error {err}")
    chunked_attention.launches += 1
    if S == 1:
        chunked_attention.decode += 1
        chunked_attention.decode_int8 += int8
    else:
        chunked_attention.prefill += 1
    return out


chunked_attention.launches = 0
chunked_attention.prefill = 0
chunked_attention.decode = 0
chunked_attention.decode_int8 = 0


class TrainAttention(torch.autograd.Function):
    """K3e: K3's prefill kernel under autograd, the reference's
    ``kernels/ops.py::_flash_vjp`` (:20-44).  The forward launches the
    kernel through :func:`chunked_attention` (counted on its prefill
    route) and saves the caller's q, k, v and positions; the backward
    recomputes the plain chunked twin (``ref.chunked_attention_ref``, the
    reference's ``_flash_bwd`` recomputes its jnp oracle) under autograd
    and returns its gradients for q, k and v.  It launches no K3: a
    dedicated backward kernel is ROADMAP Queue 2's."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window, block):
        ctx.save_for_backward(q, k, v, q_pos, kv_pos)
        ctx.mask = (causal, window, block)
        return chunked_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                 window=window)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels import ref

        q, k, v, q_pos, kv_pos = ctx.saved_tensors
        causal, window, block = ctx.mask
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = ref.chunked_attention_ref(*leaves, q_pos, kv_pos,
                                            causal=causal, window=window,
                                            block=block)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None, None, None)


def train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block: int = 512) -> torch.Tensor:
    """K3 where q, k or v requires grad (K3e), on CUDA tensors; ``block``
    is the backward's plain KV chunk.  Decode (S = 1) and int8 K/V raise
    ``NotImplementedError``: no path trains through them."""
    if q.shape[1] == 1:
        raise NotImplementedError(
            "attention under autograd at S = 1 (decode) is not ported: "
            "K3e runs the prefill kernel, and no path trains a decode step")
    if k.dtype == torch.int8:
        raise NotImplementedError(
            "attention under autograd over int8 K/V is not ported: int8 "
            "K/V are a decode cache's, which no path trains")
    return TrainAttention.apply(q, k, v, q_pos, kv_pos, causal, window,
                                block)


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
