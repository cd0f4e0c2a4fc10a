# Port of src/repro/models/attention.py:18-368 in torch: _cache_write,
# chunked_attention, the GQA block, full and sliding-window, with RoPE or
# M-RoPE, the MLA block (DeepSeek-V2), each with its int8 KV cache, and
# the enc-dec cross attention.
"""GQA, MLA and cross attention with a chunked online-softmax core.

:func:`chunked_attention` is the contract the serving model runs; on the
card it launches the attention kernel (K3), on the CPU it runs the plain
chunked twin (``kernels/ops.py`` decides by the tensor's device).  MLA's
expanded path (prefill) runs it at Dk = qk_nope + qk_rope, Dv = v_dim; its
decode runs the reference's absorbed einsums over the compressed cache.

An int8 cache quantises on write (:func:`quantise`: per token and kv head,
or per token for MLA's latent and shared key) and keeps the f32 scales in
cache leaves of their own; GQA decode hands them to K3, which dequantises
as it loads, and MLA's absorbed einsums multiply them into the scores and
the weights, as the reference does.

In a sharding context (``models/sharding.py``) :func:`gqa_block` runs
over each device's heads: ``wq``/``wk``/``wv`` column-parallel, ``wo``
row-parallel (its partial sums reduced by the caller), K3 over the local
heads of the folded batch in one launch.  Where the KV heads do not divide
the model axis but the q heads do, every device holds all KV heads (the
cache too) and passes K3 the ones its q heads use.

:func:`mla_block` splits its query heads (the reference's ``attention.py
:247``): ``q_a``, ``kv_a`` and the two latent norms are whole, so every
device computes the latent ``c_kv`` and the shared key whole (and writes
the same ``cc``/``cr``), ``q_b``/``kv_b`` are its heads' columns and ``wo``
their rows.  Its prefill expands K/V for the local heads only; its decode
runs the absorbed einsums for them over the whole latent cache.
:func:`cross_block` and :func:`encode_kv` run over the device's heads too,
against ``enc_k``/``enc_v`` split on heads.

Cross attention (:func:`cross_block`, the enc-dec decoder's) runs the same
core with positions that encode only a mask: every query at ``2**29`` and
every encoder frame at 0, or at ``2**30`` where the encoder mask says the
frame is not valid, so a query sees exactly the valid frames.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import sharding as SHD
from repro_torch.models.layers import (apply_mrope, apply_rope, dense_init,
                                       rms_norm)

NEG_INF = -1e30


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


def quantise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(int8 values, scale)`` of ``x`` over its last dim, as the
    reference's ``attention.py:198-203``: scale ``max(|x|.max(-1), 1e-6) /
    127`` and values ``clip(round(x / scale), -127, 127)``, both in x's
    dtype before the cast (torch's round, like jnp's, rounds half to
    even)."""
    s = torch.clamp(x.abs().amax(-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(x / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                      causal: bool = True, window: int = 0, block: int = 512,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """q: (B,S,H,Dk), k: (B,T,K,Dk), v: (B,T,K,Dv); H = K*G.

    Online softmax over KV blocks with f32 running (max, sum, acc); invalid
    cache slots carry ``kv_pos`` > any real position (2**30) and are
    causally masked; a row with no valid key gives 0.  int8 K/V come with
    their (B,T,K) f32 ``k_scale``/``v_scale``."""
    scales = ({} if k_scale is None
              else dict(k_scale=k_scale, v_scale=v_scale))
    return ops.chunked_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                 window=window, block=block, **scales)


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
              rope_theta: float = 1e4, mrope: bool = False,
              window: int = 0, block: int = 512,
              kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]] = None,
              cache_index: Optional[torch.Tensor] = None,
              rows: Optional[torch.Tensor] = None,
              kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Self-attention; ``window > 0`` masks keys older than
    ``position - window + 1`` (sliding window).  Without ``kv_cache``:
    causal over ``x``; returns ``(y, (k, v))`` with the roped K/V a prefill
    writes into its cache.  With ``kv_cache=(k, v, kv_pos)`` (a linear or
    ring buffer): one decode token per row; the new K/V and position are
    written IN PLACE at ``cache_index`` (the ring slot, which the caller
    computes) for the batch rows in ``rows``, and attention runs over the
    cache; returns ``(y, kv_cache)``.  An int8 cache comes with
    ``kv_scales=(k_scale, v_scale)`` (B,T,K) f32: K/V are quantised on
    write (:func:`quantise`) and their scales written at the same slot.
    positions: (B, S) int32, or (3, B, S) under ``mrope`` (M-RoPE's
    temporal, height and width ids), whose temporal ids ``positions[0]``
    are the causal positions and the ones written to the cache."""
    B, S, _ = x.shape
    q = SHD.matmul(x, params["wq"])
    k = SHD.matmul(x, params["wk"])
    v = SHD.matmul(x, params["wv"])
    if "bq" in params:
        q, k, v = (SHD.add(q, params["bq"]), SHD.add(k, params["bk"]),
                   SHD.add(v, params["bv"]))
    # in a sharding context, each device's heads (all of them but where
    # the weights are its slice)
    hl, kl = q.shape[-1] // head_dim, k.shape[-1] // head_dim
    rope = apply_mrope if mrope else apply_rope
    q = rope(q.reshape(B, S, hl, head_dim), positions, rope_theta)
    k = rope(k.reshape(B, S, kl, head_dim), positions, rope_theta)
    v = v.reshape(B, S, kl, head_dim)
    tok_pos = positions[0] if mrope else positions
    pick = (lambda t: t) if hl * n_kv == kl * n_heads else (
        lambda t: _local_kv(t, n_heads, n_kv, hl))

    if kv_cache is None:
        out = chunked_attention(q, pick(k), pick(v), tok_pos, tok_pos,
                                causal=True, window=window, block=block)
        new = (k, v)
    else:
        ck, cv, cpos = kv_cache
        ks = vs = None
        if ck.dtype == torch.int8:
            ks, vs = kv_scales
            (k, k_s), (v, v_s) = quantise(k), quantise(v)
            _cache_write(ks, k_s, cache_index, rows)
            _cache_write(vs, v_s, cache_index, rows)
        _cache_write(ck, k, cache_index, rows)
        _cache_write(cv, v, cache_index, rows)
        _cache_write(cpos, tok_pos.to(cpos.dtype), cache_index, rows)
        if ks is not None:
            ks, vs = (pick(t[..., None])[..., 0] for t in (ks, vs))
        out = chunked_attention(q, pick(ck), pick(cv), tok_pos, cpos,
                                causal=True, window=window, block=block,
                                k_scale=ks, v_scale=vs)
        new = kv_cache
    y = SHD.matmul(out.reshape(B, S, hl * head_dim), params["wo"])
    return y, new


def _local_kv(t: torch.Tensor, n_heads: int, n_kv: int,
              hl: int) -> torch.Tensor:
    """Of a folded (B, T, n_kv, D) K or V that every device holds whole,
    each device's rows' KV heads that its ``hl`` local q heads use (local
    head j of model position i is global head i * hl + j, its KV head
    that over the group size): a run of whole groups, one head shared by
    all ``hl``, or else one KV head a q head."""
    g = n_heads // n_kv
    mi = SHD.model_index()[:, None]
    if hl % g == 0:
        idx = mi * (hl // g) + torch.arange(hl // g, device=t.device)
    elif g % hl == 0:
        idx = mi * hl // g
    else:
        idx = (mi * hl + torch.arange(hl, device=t.device)) // g
    d = SHD.dev(t)                                # (n, b, T, n_kv, D)
    n, b, T = d.shape[:3]
    idx = idx.view(n, 1, 1, -1, 1).expand(n, b, T, idx.shape[1],
                                          *d.shape[4:])
    return torch.gather(d, 3, idx).flatten(0, 1)


# ---------------------------------------------------------------------------
# MLA (Multi-head Latent Attention, DeepSeek-V2) with compressed decode cache.
# ---------------------------------------------------------------------------

def init_mla_params(gen: torch.Generator, d_model: int, n_heads: int,
                    q_lora: int, kv_lora: int, qk_nope: int, qk_rope: int,
                    v_dim: int, reps: int = 1, dtype=torch.float32,
                    device=None) -> Dict:
    """Stacked (reps, ...) MLA weights on ``device`` (default: cuda,
    raising without a GPU); the two latent norms stay f32, as the
    reference's."""
    device = resolve_device(device)

    def w(shape):
        return dense_init(gen, (reps,) + shape, dtype=dtype, device=device)

    return {
        "q_a": w((d_model, q_lora)),
        "q_norm": torch.zeros((reps, q_lora), device=device),
        "q_b": w((q_lora, n_heads * (qk_nope + qk_rope))),
        "kv_a": w((d_model, kv_lora + qk_rope)),
        "kv_norm": torch.zeros((reps, kv_lora), device=device),
        "kv_b": w((kv_lora, n_heads * (qk_nope + v_dim))),
        "wo": w((n_heads * v_dim, d_model)),
    }


def _mla_qkr(params: Dict, x: torch.Tensor, positions: torch.Tensor,
             n_heads: int, qk_nope: int, qk_rope: int, kv_lora: int,
             rope_theta: float):
    """(q_nope (B,S,H,nope), roped q_rope (B,S,H,rope), the normed latent
    c_kv (B,S,kv_lora), the roped shared key k_rope (B,S,rope)); H the
    local heads in a sharding context."""
    B, S, _ = x.shape
    cq = SHD.norm(rms_norm, SHD.matmul(x, params["q_a"]), params["q_norm"])
    q = SHD.matmul(cq, params["q_b"]).reshape(B, S, -1, qk_nope + qk_rope)
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    q_rope = apply_rope(q_rope, positions, rope_theta)
    ckv = SHD.matmul(x, params["kv_a"])
    c_kv = SHD.norm(rms_norm, ckv[..., :kv_lora], params["kv_norm"])
    k_rope = apply_rope(ckv[..., kv_lora:][:, :, None, :], positions,
                        rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def mla_block(params: Dict, x: torch.Tensor, positions: torch.Tensor, *,
              n_heads: int, q_lora: int, kv_lora: int, qk_nope: int,
              qk_rope: int, v_dim: int, rope_theta: float = 1e4,
              block: int = 512,
              kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]] = None,
              cache_index: Optional[torch.Tensor] = None,
              rows: Optional[torch.Tensor] = None,
              kv_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Without ``kv_cache`` (prefill, train): K and V expanded per head, K
    ``[k_nope, k_rope broadcast over heads]`` (qk_nope + qk_rope wide), V
    v_dim wide, causal through :func:`chunked_attention`; returns ``(y,
    (c_kv, k_rope))``, the compressed entries a prefill writes into its
    cache.  With ``kv_cache=(cc, cr, kv_pos)`` (B,T,kv_lora), (B,T,rope):
    one decode token per row, its latent, shared key and position written
    IN PLACE at ``cache_index`` for the batch rows in ``rows``, and the
    *absorbed* attention over the compressed cache in the reference's order
    of dtypes (the cache cast to q's, scores to f32 for the softmax, the
    weights back to q's); returns ``(y, kv_cache)``.  An int8 cache comes
    with ``kv_scales=(cc_scale, cr_scale)`` (B,T) f32: the latent and the
    shared key are quantised per token on write, and the scales multiply
    the nope and rope scores and the weights over the latent (the
    reference's ``attention.py:293-330``).  positions: (B, S)."""
    B, S, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkr(
        params, x, positions, n_heads, qk_nope, qk_rope, kv_lora, rope_theta)
    hl = q_nope.shape[2]                        # the local heads
    w_kv = params["kv_b"].unflatten(-1, (hl, qk_nope + v_dim))
    w_uk, w_uv = w_kv[..., :qk_nope], w_kv[..., qk_nope:]

    if kv_cache is None:
        kv = SHD.einsum("btc,chd->bthd", c_kv, w_kv)
        k_nope, v = kv[..., :qk_nope], kv[..., qk_nope:]
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            B, S, hl, qk_rope)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = chunked_attention(q, k, v, positions, positions, causal=True,
                                block=block)
        new = (c_kv, k_rope)
    else:
        cc, cr, cpos = kv_cache
        cs = rs = None
        if cc.dtype == torch.int8:
            cs, rs = kv_scales
            (c_kv, c_s), (k_rope, r_s) = quantise(c_kv), quantise(k_rope)
            _cache_write(cs, c_s, cache_index, rows)
            _cache_write(rs, r_s, cache_index, rows)
        _cache_write(cc, c_kv, cache_index, rows)
        _cache_write(cr, k_rope, cache_index, rows)
        _cache_write(cpos, positions.to(cpos.dtype), cache_index, rows)
        scale = (qk_nope + qk_rope) ** -0.5
        q_c = SHD.einsum("bshd,chd->bshc", q_nope, w_uk)
        ccq = cc.to(q_c.dtype)
        s_nope = torch.einsum("bshc,btc->bhst", q_c, ccq)
        s_rope = torch.einsum("bshd,btd->bhst", q_rope, cr.to(q_rope.dtype))
        if cs is not None:                  # undo the per-token quantisation
            s_nope = s_nope * cs[:, None, None, :]
            s_rope = s_rope * rs[:, None, None, :]
        s = (s_nope + s_rope) * scale
        valid = cpos[:, None, None, :] <= positions[:, None, :, None]
        s = torch.where(valid, s.float(), torch.full((), NEG_INF,
                                                     device=x.device))
        p = torch.softmax(s, dim=-1)
        if cs is not None:
            p = p * cs[:, None, None, :]
        ctx = torch.einsum("bhst,btc->bshc", p.to(q_c.dtype), ccq)
        out = SHD.einsum("bshc,chd->bshd", ctx, w_uv)
        new = kv_cache
    y = SHD.matmul(out.reshape(B, S, hl * v_dim), params["wo"])
    return y, new


# ---------------------------------------------------------------------------
# Cross attention (enc-dec; the seamless-m4t decoder).
# ---------------------------------------------------------------------------

def init_cross_params(gen: torch.Generator, d_model: int, n_heads: int,
                      head_dim: int, reps: int = 1, dtype=torch.float32,
                      device=None) -> Dict:
    """MHA projections without bias, as the reference's (its
    ``attention.py:341-344``)."""
    return init_gqa_params(gen, d_model, n_heads, n_heads, head_dim,
                           reps=reps, dtype=dtype, device=device)


def cross_block(params: Dict, x: torch.Tensor,
                enc_kv: Tuple[torch.Tensor, torch.Tensor],
                enc_mask: Optional[torch.Tensor], *, n_heads: int,
                head_dim: int) -> torch.Tensor:
    """The decoder's ``x`` (B, S, M) attends over the encoder's projected
    ``enc_kv`` = (k, v), each (B, T, H, D), without RoPE: queries at
    ``2**29``, frames at 0 where ``enc_mask`` (B, T) is true (every frame
    without a mask) and at ``2**30`` where it is false.  In a sharding
    context over the device's heads, its output a partial sum where
    ``wo`` is split."""
    B, S, _ = x.shape
    q = SHD.matmul(x, params["wq"]).reshape(B, S, -1, head_dim)
    k, v = enc_kv
    T = k.shape[1]
    if enc_mask is None:
        kv_pos = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    else:
        kv_pos = torch.where(enc_mask, 0, 2**30).to(torch.int32)
    q_pos = torch.full((B, S), 2**29, dtype=torch.int32, device=x.device)
    out = chunked_attention(q, k, v, q_pos, kv_pos, causal=True, block=512)
    return SHD.matmul(out.reshape(B, S, -1), params["wo"])


def encode_kv(params: Dict, enc_out: torch.Tensor, n_heads: int,
              head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross attention's (k, v), each (B, T, H, D), of the encoder's
    output (B, T, M); the device's heads in a sharding context."""
    B, T, _ = enc_out.shape
    k = SHD.matmul(enc_out, params["wk"]).reshape(B, T, -1, head_dim)
    v = SHD.matmul(enc_out, params["wv"]).reshape(B, T, -1, head_dim)
    return k, v
