# Port of src/repro/models/attention.py:18-220 in torch: _cache_write,
# chunked_attention and the GQA block, full and sliding-window.  Not ported
# yet: MLA, int8 KV, cross attention and M-RoPE (ROADMAP Queue 1 item 13).
"""GQA attention with a chunked online-softmax core.

:func:`chunked_attention` is the contract the serving model runs; on the
card it launches the attention kernel (K3), on the CPU it runs the plain
chunked twin (``kernels/ops.py`` decides by the tensor's device).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init


def _cache_write(buf: torch.Tensor, val: torch.Tensor, idx: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """Write a one-token decode update into ``buf`` IN PLACE, for the batch
    rows in ``rows`` only: ``buf[b, idx[b]] = val[b, 0]``.

    ``buf``: (B, T, ...), ``val``: (B, 1, ...), ``idx``: (B,) per-slot
    ragged positions, ``rows``: (n,) long indices of the active rows.  The
    reference writes every row and restores inactive ones with a select over
    the whole cache; writing only the active rows leaves the others
    bit-exact without that copy."""
    buf.index_put_((rows, idx.long()[rows]), val[rows, 0].to(buf.dtype))
    return buf


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                      causal: bool = True, window: int = 0, block: int = 512
                      ) -> torch.Tensor:
    """q: (B,S,H,Dk), k: (B,T,K,Dk), v: (B,T,K,Dv); H = K*G.

    Online softmax over KV blocks with f32 running (max, sum, acc); invalid
    cache slots carry ``kv_pos`` > any real position (2**30) and are
    causally masked; a row with no valid key gives 0."""
    return ops.chunked_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                 window=window, block=block)


def init_gqa_params(gen: torch.Generator, d_model: int, n_heads: int,
                    n_kv: int, head_dim: int, qkv_bias: bool = False,
                    reps: int = 1, dtype=torch.float32, device=None) -> Dict:
    """Stacked (reps, ...) projection weights on ``device`` (default: cuda,
    raising without a GPU)."""
    device = resolve_device(device)
    p = {
        "wq": dense_init(gen, (reps, d_model, n_heads * head_dim),
                         dtype=dtype, device=device),
        "wk": dense_init(gen, (reps, d_model, n_kv * head_dim), dtype=dtype,
                         device=device),
        "wv": dense_init(gen, (reps, d_model, n_kv * head_dim), dtype=dtype,
                         device=device),
        "wo": dense_init(gen, (reps, n_heads * head_dim, d_model),
                         dtype=dtype, device=device),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros((reps, width * head_dim), dtype=dtype,
                                  device=device)
    return p


def gqa_block(params: Dict, x: torch.Tensor, positions: torch.Tensor, *,
              n_heads: int, n_kv: int, head_dim: int,
              rope_theta: float = 1e4, window: int = 0, block: int = 512,
              kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]] = None,
              cache_index: Optional[torch.Tensor] = None,
              rows: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention; ``window > 0`` masks keys older than
    ``position - window + 1`` (sliding window).  Without ``kv_cache``:
    causal over ``x``; returns ``(y, (k, v))`` with the roped K/V a prefill
    writes into its cache.  With ``kv_cache=(k, v, kv_pos)`` (a linear or
    ring buffer): one decode token per row; the new K/V and position are
    written IN PLACE at ``cache_index`` (the ring slot, which the caller
    computes) for the batch rows in ``rows``, and attention runs over the
    cache; returns ``(y, kv_cache)``.  positions: (B, S) int32."""
    B, S, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = apply_rope(q.reshape(B, S, n_heads, head_dim), positions, rope_theta)
    k = apply_rope(k.reshape(B, S, n_kv, head_dim), positions, rope_theta)
    v = v.reshape(B, S, n_kv, head_dim)

    if kv_cache is None:
        out = chunked_attention(q, k, v, positions, positions, causal=True,
                                window=window, block=block)
        new = (k, v)
    else:
        ck, cv, cpos = kv_cache
        _cache_write(ck, k, cache_index, rows)
        _cache_write(cv, v, cache_index, rows)
        _cache_write(cpos, positions.to(cpos.dtype), cache_index, rows)
        out = chunked_attention(q, ck, cv, positions, cpos, causal=True,
                                window=window, block=block)
        new = kv_cache
    y = out.reshape(B, S, n_heads * head_dim) @ params["wo"]
    return y, new
