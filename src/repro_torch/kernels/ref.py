# Port of src/repro/kernels/ref.py, plus the chunked twin of
# src/repro/models/attention.py::chunked_attention (:37-126).
"""Plain PyTorch versions of every kernel: what a CPU tensor runs, and what
``chip_smoke.py`` holds each kernel to on the card.  Never the main path when
a card is present (``kernels/ops.py`` dispatches on the tensor's device)."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
POS_SENTINEL = 2**30


def check_table(table: torch.Tensor, n_pool: int) -> None:
    """Raise on page-table entries outside ``[-1, n_pool)`` (host check)."""
    bad = (table < -1) | (table >= n_pool)
    if bool(bad.any()):
        raise IndexError(f"page table entries outside [-1, {n_pool}): "
                         f"{table[bad][:8].tolist()}")


def check_copy_args(x: torch.Tensor, tile_rows: int, lanes: int) -> None:
    """Raise on what the tile copy (K4) does not take: a non-contiguous
    tensor (the reference's arrays have no strides) or a tile that is not
    positive."""
    if tile_rows < 1 or lanes < 1:
        raise ValueError(f"tile_rows and lanes must be >= 1 "
                         f"(got {tile_rows} x {lanes})")
    if not x.is_contiguous():
        raise ValueError(f"rbm_copy takes a contiguous tensor (got shape "
                         f"{tuple(x.shape)}, strides {x.stride()})")


def rbm_copy_ref(x: torch.Tensor, *, tile_rows: int = 256,
                 lanes: int = 128) -> torch.Tensor:
    """The reference's steps on tensors: flatten, pad to whole
    ``(tile_rows, lanes)`` tiles, copy the tiles one by one, unpad."""
    check_copy_args(x, tile_rows, lanes)
    flat = x.reshape(-1)
    n, per_tile = flat.numel(), tile_rows * lanes
    n_tiles = -(-n // per_tile)
    pad = n_tiles * per_tile - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    tiled = flat.view(n_tiles, tile_rows, lanes)
    out = torch.empty_like(tiled)
    for i in range(n_tiles):
        out[i].copy_(tiled[i])
    return out.reshape(-1)[:n].reshape(x.shape)


def villa_gather_ref(pages: torch.Tensor, table: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[j] = pages[table[j]]; with ``out`` given, entries of -1 leave
    ``out[j]`` as it was (a masked read)."""
    check_table(table, pages.shape[0])
    idx = table.long()
    if out is None:
        return pages.index_select(0, idx)
    keep = idx >= 0
    got = pages.index_select(0, idx.clamp(min=0))
    shape = (-1,) + (1,) * (pages.dim() - 1)
    out.copy_(torch.where(keep.view(shape), got, out))
    return out


def villa_scatter_ref(pages: torch.Tensor, table: torch.Tensor,
                      updates: torch.Tensor) -> torch.Tensor:
    """pages[table[j]] = updates[j] IN PLACE: entries of -1 are skipped and
    the last of duplicate entries wins (``index_copy_`` on the deduplicated
    table).  Returns ``pages``."""
    check_table(table, pages.shape[0])
    idx = table.long()
    order = torch.argsort(idx, stable=True)
    srt = idx[order]
    last = torch.ones_like(srt, dtype=torch.bool)
    last[:-1] = srt[:-1] != srt[1:]
    win = order[last & (srt >= 0)]
    pages.index_copy_(0, idx[win], updates[win])
    return pages


def chunked_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                          causal: bool = True, window: int = 0,
                          block: int = 512) -> torch.Tensor:
    """q: (B,S,H,Dk), k: (B,T,K,Dk), v: (B,T,K,Dv); H = K*G.  KV blocks are
    scanned with f32 running (max, sum, acc), exactly as the reference's
    jnp body; invalid cache slots carry kv_pos > any real position."""
    B, S, H, Dk = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    Dv = v.shape[-1]
    scale = Dk ** -0.5
    block = min(block, T)
    nb = -(-T // block)
    pad = nb * block - T
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=POS_SENTINEL)
    # the reference scales q in its own dtype, then casts to f32
    qr = (q.reshape(B, S, K, G, Dk) * scale).float()
    m = torch.full((B, K, G, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, K, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, S, Dv), dtype=torch.float32, device=q.device)
    qp = q_pos[:, None, None, :, None]
    for j in range(nb):
        sl = slice(j * block, (j + 1) * block)
        kj, vj, pj = k[:, sl].float(), v[:, sl].float(), kv_pos[:, sl]
        s = torch.einsum("bskgd,btkd->bkgst", qr, kj)
        valid = torch.ones((B, 1, 1, S, block), dtype=torch.bool,
                           device=q.device)
        kp = pj[:, None, None, None, :]
        if causal:
            valid = valid & (kp <= qp)
        if window > 0:
            valid = valid & (kp > qp - window)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(valid, p, torch.zeros_like(p))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", p, vj)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return (out.reshape(B, K * G, S, Dv).transpose(1, 2)
            .reshape(B, S, H, Dv).to(q.dtype))


def split_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                     n_split: int, split_len: int, causal: bool = True,
                     window: int = 0) -> torch.Tensor:
    """The split-KV decode kernel's algorithm (S = 1) in plain PyTorch, for
    the tests: each split of ``split_len`` slots keeps f32 (max, sum,
    accumulator) over its valid keys, -1e30 and 0 when it has none; then the
    splits are combined in split order, m = max m_i, l = sum l_i
    exp(m_i - m), the accumulator likewise over the splits with l_i > 0,
    out = acc / max(l, 1e-30).  q: (B,1,H,D), k/v: (B,T,K,D)."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if S != 1 or n_split * split_len < T:
        raise ValueError(f"decode takes S = 1 and splits covering T = {T} "
                         f"(got S {S}, {n_split} x {split_len})")
    G = H // K
    qr = (q.reshape(B, K, G, D) * D ** -0.5).float()
    qp = q_pos.reshape(B, 1, 1, 1)
    parts = []
    for i in range(n_split):
        sl = slice(i * split_len, min(T, (i + 1) * split_len))
        kp = kv_pos[:, sl][:, None, None, :]
        s = torch.einsum("bkgd,btkd->bkgt", qr, k[:, sl].float())
        valid = torch.ones_like(s, dtype=torch.bool)
        if causal:
            valid = valid & (kp <= qp)
        if window > 0:
            valid = valid & (kp > qp - window)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m = torch.full(s.shape[:-1], NEG_INF, dtype=torch.float32,
                       device=q.device)
        if s.shape[-1]:
            m = torch.maximum(m, s.amax(-1))
        p = torch.where(valid, torch.exp(s - m[..., None]),
                        torch.zeros_like(s))
        parts.append((m, p.sum(-1),
                      torch.einsum("bkgt,btkd->bkgd", p, v[:, sl].float())))
    m = parts[0][0]
    for mi, _, _ in parts[1:]:
        m = torch.maximum(m, mi)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for mi, li, ai in parts:
        c = torch.exp(mi - m)
        l = l + li * c
        acc = acc + torch.where((li > 0)[..., None], ai * c[..., None],
                                torch.zeros_like(ai))
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, 1, H, D).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """Exact softmax attention.  q: (B,H,S,D), k/v: (B,K,T,D), H = K*G; the
    q rows sit at the tail of the kv sequence."""
    B, H, S, D = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    qr = q.reshape(B, K, G, S, D).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qr, k.float()) * D ** -0.5
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    valid = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid & (k_pos <= q_pos + (T - S))
    if window > 0:
        valid = valid & (k_pos > q_pos + (T - S) - window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return o.reshape(B, H, S, D).to(q.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value, ties away from zero (the prefill
    kernel's operand rounding: half an ulp added to the magnitude bits, the
    low 13 bits cleared), as f32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 by dropping the low 13 bits: what the tensor cores read
    of an f32 operand that is not already TF32."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(
        torch.float32)


def _tc_dot(a: torch.Tensor, b: torch.Tensor, eq: str,
            split: bool) -> torch.Tensor:
    """einsum ``eq`` of f32 operands as the prefill kernel's TF32 MMAs
    compute it: with ``split``, a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (hi the
    TF32 rounding, lo the rest truncated to TF32), else a_hi.b_hi."""
    ah, bh = tf32_round(a), tf32_round(b)
    if not split:
        return torch.einsum(eq, ah, bh)
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def prefill_tc_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                   causal: bool = True, window: int = 0, keys: int = 64,
                   split: bool = True) -> torch.Tensor:
    """The f32 prefill kernel's arithmetic in plain PyTorch, for the tests:
    tiles of ``keys`` keys, scores and P.V through :func:`_tc_dot` (3xTF32
    with ``split``, one TF32 pass without), masks from kv_pos, the online
    softmax in f32 per tile, -1e30 for a masked score, out = acc /
    max(l, 1e-30).  q: (B,S,H,D), k/v: (B,T,K,D) float32."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qr = q.reshape(B, S, K, G, D).float() * D ** -0.5
    qp = q_pos[:, None, None, :, None]
    m = torch.full((B, K, G, S), NEG_INF, dtype=torch.float32)
    l = torch.zeros((B, K, G, S), dtype=torch.float32)
    acc = torch.zeros((B, K, G, S, D), dtype=torch.float32)
    for t0 in range(0, T, keys):
        sl = slice(t0, min(T, t0 + keys))
        s = _tc_dot(qr, k[:, sl].float(), "bskgd,btkd->bkgst", split)
        kp = kv_pos[:, sl][:, None, None, None, :]
        valid = torch.ones_like(s, dtype=torch.bool)
        if causal:
            valid = valid & (kp <= qp)
        if window > 0:
            valid = valid & (kp > qp - window)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _tc_dot(p, v[:, sl].float(),
                                              "bkgst,btkd->bkgsd", split)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


F32_BAR, BF16_CAP = 3e-5, 2e-2      # K3's bars against chunked_attention_ref


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at ``|x|``: 2**(e - 8) for |x| in
    [2**(e-1), 2**e), 0 where x is 0."""
    a = x.float().abs()
    _, e = torch.frexp(a)
    return torch.where(a > 0, torch.ldexp(torch.ones_like(a), e - 8),
                       torch.zeros_like(a))


def attention_bar(got: torch.Tensor, want: torch.Tensor, q: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                  kv_pos: torch.Tensor, *, causal: bool = True,
                  window: int = 0) -> torch.Tensor:
    """The bar, element by element, that K3's output ``got`` meets against
    ``want``, :func:`chunked_attention_ref` on the same inputs.  An f32
    output: F32_BAR.  A bf16 output is the rounding of an f32 result that
    lies within F32_BAR of the plain version's, so it may sit one bf16 step
    from ``want``: F32_BAR plus two ulps (twice that step) of the larger of
    the two.  Where q
    and K/V are both bf16 and S > 1 the prefill kernel rounds the weights P
    to bf16 for P V, each off by at most 2**-9 of itself (its row sum too),
    which adds 2**-8 of the same attention over |v|.  Never above
    BF16_CAP."""
    if got.dtype == torch.float32:
        return torch.full(got.shape, F32_BAR, device=got.device)
    bar = F32_BAR + 2 * bf16_ulp(torch.maximum(got.float().abs(),
                                               want.float().abs()))
    if q.shape[1] > 1 and q.dtype == k.dtype == torch.bfloat16:
        bar = bar + 2**-8 * chunked_attention_ref(
            q, k, v.abs(), q_pos, kv_pos, causal=causal,
            window=window).float()
    return bar.clamp(max=BF16_CAP)
