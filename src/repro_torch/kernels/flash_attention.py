# Port of src/repro/kernels/flash_attention.py::flash_attention (:81-131) as
# the CUDA kernel of csrc/flash_attention.cu, in the contract of
# src/repro/models/attention.py::chunked_attention (:37-126).
"""Launch wrapper of the attention kernel (K3) and the (B,H,S,D) layout
wrapper around it.

:func:`chunked_attention` launches ``csrc/flash_attention.cu`` on CUDA
tensors in the serving model's layout — q (B,S,H,D), k/v (B,T,K,D), per-row
positions — checks device, dtype, contiguity and shape, launches on
``torch.cuda.current_stream()``, allocates its output with ``torch.empty``,
raises if the launch reports an error, and counts its launches in
``chunked_attention.launches``.  It takes the reference's causal and
sliding-window masks (``window > 0``, the ``attn_local`` layers).  It raises
``NotImplementedError`` on Dv != Dk (MLA) and ``ValueError`` on a head_dim
outside 16/32/64/128 (gemma-7b's 256): ROADMAP Queue 2 lists both under K3.
int8 K/V, whose scales the reference passes here, has no entry yet.
CPU tensors never reach it: :mod:`repro_torch.kernels.ops` routes them to the
plain chunked twin.

:func:`flash_attention` is the reference kernel's own signature: q
(B,H,S,D), k/v (B,K,T,D), q rows at the tail of the kv sequence
(``q_pos = i + T - S``).  It builds those positions and goes through the
same dispatch, so on the card it runs the same kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_LIB = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.library("flash_attention")
        lib.flash_attention_launch.argtypes = (
            [_P] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int, _P])
        lib.flash_attention_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """K3 on the card.  q: (B,S,H,D), k/v: (B,T,K,D), q_pos (B,S) and
    kv_pos (B,T) int32; key t is valid for query s iff kv_pos <= q_pos
    (causal) and kv_pos > q_pos - window (window > 0).  Returns (B,S,H,D) in
    q's dtype."""
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
                    ("kv_pos", kv_pos)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share float32 or bfloat16 "
                         f"(got {q.dtype}, {k.dtype}, {v.dtype})")
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
    if D not in (16, 32, 64, 128) or H // K > 64:
        raise ValueError(f"head_dim {D} / group {H // K}: the kernel takes "
                         f"head_dim 16, 32, 64 or 128 and groups of at most "
                         f"64")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_pos = kv_pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        kv_pos.data_ptr(), out.data_ptr(), B, S, T, H, K, D, int(causal),
        int(window), D ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"attention kernel launch failed: error {err}")
    chunked_attention.launches += 1
    return out


chunked_attention.launches = 0


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
