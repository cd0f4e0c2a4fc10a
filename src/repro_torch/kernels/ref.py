# Port of src/repro/kernels/ref.py, plus the chunked twin of
# src/repro/models/attention.py::chunked_attention (:37-126).
"""Plain PyTorch versions of every kernel: what a CPU tensor runs, and what
``chip_smoke.py`` holds each kernel to on the card.  Never the main path when
a card is present (``kernels/ops.py`` dispatches on the tensor's device)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.scales import check_scales

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


def _dequant(x: torch.Tensor, scale: Optional[torch.Tensor],
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K or V as f32 (or ``dtype``): an int8 cache's values times their
    (B,T,K) scales (the reference's ``x.astype(f32) * scale[..., None]``),
    else widened."""
    if scale is None:
        return x.to(dtype)
    return x.to(dtype) * scale[..., None]


def chunked_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                          causal: bool = True, window: int = 0,
                          block: int = 512,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None,
                          compute_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """q: (B,S,H,Dk), k: (B,T,K,Dk), v: (B,T,K,Dv); H = K*G.  KV blocks are
    scanned with f32 running (max, sum, acc), exactly as the reference's
    jnp body; invalid cache slots carry kv_pos > any real position.  int8
    K/V come with (B,T,K) f32 ``k_scale``/``v_scale`` and are dequantised
    block by block (the reference's ``attention.py:81-97``: padded keys
    get scale 0 and position 2**30).  ``compute_dtype`` f64 runs every
    f32 step in f64 instead (:func:`twin_grads_f64`)."""
    check_scales(k, k_scale, v_scale)
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
        if k_scale is not None:
            k_scale = torch.nn.functional.pad(k_scale, (0, 0, 0, pad))
            v_scale = torch.nn.functional.pad(v_scale, (0, 0, 0, pad))
    # the reference scales q in its own dtype, then casts to f32
    cd = compute_dtype
    qr = (q.reshape(B, S, K, G, Dk) * scale).to(cd)
    m = torch.full((B, K, G, S), NEG_INF, dtype=cd, device=q.device)
    l = torch.zeros((B, K, G, S), dtype=cd, device=q.device)
    acc = torch.zeros((B, K, G, S, Dv), dtype=cd, device=q.device)
    qp = q_pos[:, None, None, :, None]
    for j in range(nb):
        sl = slice(j * block, (j + 1) * block)
        kj = _dequant(k[:, sl], None if k_scale is None else k_scale[:, sl],
                      cd)
        vj = _dequant(v[:, sl], None if v_scale is None else v_scale[:, sl],
                      cd)
        pj = kv_pos[:, sl]
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


def twin_grads_f64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, kv_pos: torch.Tensor,
                   dout: torch.Tensor, *, causal: bool = True,
                   window: int = 0) -> tuple:
    """dq, dk, dv of :func:`chunked_attention_ref` in f64 over one block of
    all T keys (the exact function), by autograd: the standard K3e's
    backward is held to, beside the twin's own gradients in the inputs'
    dtypes (:func:`rel_l2`)."""
    leaves = [t.detach().double().requires_grad_() for t in (q, k, v)]
    out = chunked_attention_ref(*leaves, q_pos, kv_pos, causal=causal,
                                window=window, block=k.shape[1],
                                compute_dtype=torch.float64)
    return torch.autograd.grad(out, leaves, dout.double())


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative L2 gap of ``a`` to ``b`` (the absolute one where ``b`` is
    all zero)."""
    d = (a.double() - b.double()).norm()
    return float(d / b.double().norm()) if b.any() else float(d)


def split_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                     n_split: int, split_len: int, causal: bool = True,
                     window: int = 0,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The split-KV decode kernel's algorithm (S = 1) in plain PyTorch, for
    the tests: each split of ``split_len`` slots keeps f32 (max, sum,
    accumulator) over its valid keys, -1e30 and 0 when it has none; then the
    splits are combined in split order, m = max m_i, l = sum l_i
    exp(m_i - m), the accumulator likewise over the splits with l_i > 0,
    out = acc / max(l, 1e-30).  q: (B,1,H,D), k/v: (B,T,K,D); int8 K/V
    with (B,T,K) f32 scales are dequantised as each key is read."""
    check_scales(k, k_scale, v_scale)
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
        ks = None if k_scale is None else k_scale[:, sl]
        vs = None if v_scale is None else v_scale[:, sl]
        s = torch.einsum("bkgd,btkd->bkgt", qr, _dequant(k[:, sl], ks))
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
                      torch.einsum("bkgt,btkd->bkgd", p,
                                   _dequant(v[:, sl], vs))))
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
    max(l, 1e-30).  q: (B,S,H,Dk), k: (B,T,K,Dk), v: (B,T,K,Dv) float32."""
    B, S, H, D = q.shape
    T, K, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // K
    qr = q.reshape(B, S, K, G, D).float() * D ** -0.5
    qp = q_pos[:, None, None, :, None]
    m = torch.full((B, K, G, S), NEG_INF, dtype=torch.float32)
    l = torch.zeros((B, K, G, S), dtype=torch.float32)
    acc = torch.zeros((B, K, G, S, Dv), dtype=torch.float32)
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
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dv).to(q.dtype)


def prefill_short_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, kv_pos: torch.Tensor, plan, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """The short form of the f32 prefill kernel (``prefill_plan``'s form
    "short", csrc/flash_attention.cu's ``prefill_short_kernel``) CTA by CTA,
    for the tests: each CTA of ``plan``'s grid takes its rows
    (``prefill_row``) and output columns (``prefill_cols``), q * scale as
    the kernel scales it, and each of its 64 // rows key parts (the warps
    of a 16-row block: part p the keys 64 p / parts.. of every
    ``plan.keys``-key tile) runs the
    online softmax of :func:`prefill_tc_ref` (3xTF32 through
    :func:`_tc_dot`) over its keys alone; then the parts are rescaled to
    the row's largest max and summed in order, and out = their sum /
    max(L, 1e-30), L the rescaled sums.  q: (B,S,H,Dk), k: (B,T,K,Dk), v:
    (B,T,K,Dv), all f32.  Returns (B,S,H,Dv) f32."""
    from repro_torch.kernels import flash_attention as FA

    B, S, H, D = q.shape
    T, K, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // K
    parts = 64 // plan.rows
    nk = plan.keys // parts
    qs = q * D ** -0.5
    out = torch.zeros((B, S, H, Dv), dtype=torch.float32)
    for b in range(B):
        for kvh in range(K):
            for x in range(plan.grid[0]):
                cells = [FA.prefill_row(plan, S, G, x, kvh, r)
                         for r in range(plan.rows)]
                cells = [c for c in cells if c is not None]
                if not cells:
                    continue
                c0, c1 = FA.prefill_cols(plan, x, Dv)
                s_idx = torch.tensor([s for s, _ in cells])
                h_idx = torch.tensor([h for _, h in cells])
                qr = qs[b, s_idx, h_idx]                         # (R, Dk)
                qp = q_pos[b, s_idx][:, None]
                R = len(cells)
                m = torch.full((parts, R), NEG_INF)
                l = torch.zeros((parts, R))
                acc = torch.zeros((parts, R, c1 - c0))
                for t0 in range(0, T, plan.keys):
                    for p in range(parts):
                        sl = slice(min(T, t0 + p * nk),
                                   min(T, t0 + (p + 1) * nk))
                        if sl.start == sl.stop:
                            continue
                        sc = _tc_dot(qr, k[b, sl, kvh].float(), "rd,td->rt",
                                     True)
                        valid = _valid(kv_pos[b, sl][None, :], qp, causal,
                                       window)
                        sc = torch.where(valid, sc,
                                         torch.full_like(sc, NEG_INF))
                        m_new = torch.maximum(m[p], sc.amax(-1))
                        w = torch.where(valid,
                                        torch.exp(sc - m_new[:, None]),
                                        torch.zeros_like(sc))
                        corr = torch.exp(m[p] - m_new)
                        l[p] = l[p] * corr + w.sum(-1)
                        acc[p] = acc[p] * corr[:, None] + _tc_dot(
                            w, v[b, sl, kvh, c0:c1].float(), "rt,td->rd",
                            True)
                        m[p] = m_new
                f = torch.exp(m - m.amax(0))
                num = (f[..., None] * acc).sum(0)
                den = torch.clamp((f * l).sum(0), min=1e-30)
                out[b, s_idx, h_idx, c0:c1] = num / den[:, None]
    return out


def _valid(kp: torch.Tensor, qp: torch.Tensor, causal: bool,
           window: int) -> torch.Tensor:
    """The masks on broadcast positions: key kp valid for query qp."""
    valid = torch.ones(torch.broadcast_shapes(kp.shape, qp.shape),
                       dtype=torch.bool, device=kp.device)
    if causal:
        valid = valid & (kp <= qp)
    if window > 0:
        valid = valid & (kp > qp - window)
    return valid


def prefill_lse_ref(q: torch.Tensor, k: torch.Tensor, q_pos: torch.Tensor,
                    kv_pos: torch.Tensor, *, causal: bool = True,
                    window: int = 0, keys: int = 64,
                    split: bool = True) -> torch.Tensor:
    """The log-sum-exp the prefill kernels write for K3e's backward, as
    :func:`prefill_tc_ref` computes its rows: q scaled in its own dtype,
    scores through :func:`_tc_dot` in tiles of ``keys``, the running max m
    and sum l in f32; lse = m + log(l), +inf for a row with no valid key.
    q: (B,S,H,D), k: (B,T,K,D).  Returns (B,H,S) float32."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qr = (q.reshape(B, S, K, G, D) * D ** -0.5).float()
    qp = q_pos[:, None, None, :, None]
    m = torch.full((B, K, G, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, K, G, S), dtype=torch.float32, device=q.device)
    for t0 in range(0, T, keys):
        sl = slice(t0, min(T, t0 + keys))
        s = _tc_dot(qr, k[:, sl].float(), "bskgd,btkd->bkgst", split)
        valid = _valid(kv_pos[:, sl][:, None, None, None, :], qp, causal,
                       window)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        l = l * torch.exp(m - m_new) + p.sum(-1)
        m = m_new
    lse = torch.where(l > 0, m + torch.log(l),
                      torch.full_like(l, float("inf")))
    return lse.reshape(B, H, S)


def attention_backward_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, out: torch.Tensor,
                           lse: torch.Tensor, dout: torch.Tensor,
                           q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                           causal: bool = True, window: int = 0,
                           keys: int = 64, split: bool = True):
    """K3e's backward kernel's algorithm (csrc/flash_backward.cu) in plain
    PyTorch, for the tests: Delta = rowsum(dout * out) in f32; qs = q
    scaled in its own dtype, widened; then over key blocks of ``keys``, S
    = qs K^T, P = exp(S - lse) on the valid keys (0 elsewhere, and on a
    row whose lse is +inf), dV = P^T dO and dK = dS^T qs summed over the
    group's heads, dP = dO V^T, dS = P (dP - Delta), and dQ += dS K over
    the blocks, times the scale at the end; every product through
    :func:`_tc_dot` (3xTF32 with ``split``).  q, out, dout (B,S,H,D), k, v
    (B,T,K,D), lse (B,H,S).  Returns (dq, dk, dv) in q's and K/V's
    dtypes."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = D ** -0.5
    qs = (q.reshape(B, S, K, G, D) * scale).float()
    do = dout.reshape(B, S, K, G, D).float()
    delta = (do * out.reshape(B, S, K, G, D).float()).sum(-1)
    delta = delta.permute(0, 2, 3, 1)[..., None]               # (B,K,G,S,1)
    lse = lse.reshape(B, K, G, S, 1)
    qp = q_pos[:, None, None, :, None]
    dq = torch.zeros((B, S, K, G, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, T, K, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, T, K, D), dtype=torch.float32, device=q.device)
    for t0 in range(0, T, keys):
        sl = slice(t0, min(T, t0 + keys))
        kt, vt = k[:, sl].float(), v[:, sl].float()
        s = _tc_dot(qs, kt, "bskgd,btkd->bkgst", split)
        valid = _valid(kv_pos[:, sl][:, None, None, None, :], qp, causal,
                       window)
        p = torch.where(valid, torch.exp(s - lse), torch.zeros_like(s))
        dv[:, sl] = _tc_dot(p, do, "bkgst,bskgd->btkd", split)
        dp = _tc_dot(do, vt, "bskgd,btkd->bkgst", split)
        ds = p * (dp - delta)
        dk[:, sl] = _tc_dot(ds, qs, "bkgst,bskgd->btkd", split)
        dq = dq + _tc_dot(ds, kt, "bkgst,btkd->bskgd", split)
    return ((dq * scale).reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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
