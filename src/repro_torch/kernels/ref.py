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
