# Port of src/repro/core/lisa/ring_attention.py:23-66 in torch, over a mesh
# axis object (repro_torch/launch/mesh.py).  The merge is the reference's
# jnp, with no pallas_call, so it stays plain torch here.
"""Ring attention: context parallelism as a LISA hop chain.

The sequence is sharded over a mesh axis; each device keeps its Q shard and
the KV shards rotate around the ring via ``rbm.ring_scan`` — one hop per
step, overlapped with that step's blockwise attention (online softmax
merge).  This is the paper's substrate verbatim: the KV block is the "row
buffer", the hop is the inter-subarray link, and the per-hop compute is the
bank that keeps serving during the move (DESIGN.md §2).  On a StackedAxis
on the card each hop is one launch of the page gather K2.
"""
from __future__ import annotations

import torch

from repro_torch.core.lisa import rbm

NEG_INF = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis, *, causal: bool = True) -> torch.Tensor:
    """q/k/v: (local, B, S_loc, H|K, D) — each local device's shard, the
    sequence sharded over ``axis`` in axis order.  Returns the local output
    shards (local, B, S_loc, H, Dv)."""
    n = axis.size
    idx = axis.index()
    L, B, S, H, Dk = q.shape
    K = k.shape[3]
    G = H // K
    Dv = v.shape[-1]
    scale = Dk ** -0.5
    ar = torch.arange(S, device=q.device)

    q_pos = idx[:, None] * S + ar                               # (L, S)
    qr = (q.reshape(L, B, S, K, G, Dk) * scale).to(torch.float32)

    def merge(carry, kv_shard, src):
        m, l, acc = carry
        kj = kv_shard[:, 0]                                     # (L,B,S,K,Dk)
        vj = kv_shard[:, 1]
        kv_pos = src[:, None] * S + ar                          # (L, T)
        s = torch.einsum("lbskgd,lbtkd->lbkgst", qr, kj)
        if causal:
            valid = (kv_pos[:, None, :] <= q_pos[:, :, None])   # (L, S, T)
            valid = valid[:, None, None, None]
            s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        if causal:
            p = torch.where(valid, p, 0.0)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1)
        acc_new = acc * corr[..., None] + torch.einsum(
            "lbkgst,lbtkd->lbkgsd", p, vj)
        return m_new, l_new, acc_new

    kv = torch.stack([k.to(torch.float32), v.to(torch.float32)], dim=1)
    f32 = dict(dtype=torch.float32, device=q.device)
    init = (torch.full((L, B, K, G, S), NEG_INF, **f32),
            torch.zeros((L, B, K, G, S), **f32),
            torch.zeros((L, B, K, G, S, Dv), **f32))
    m, l, acc = rbm.ring_scan(kv, axis, merge, init)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(L, B, K * G, S, Dv).transpose(2, 3).reshape(
        L, B, S, H, Dv).to(q.dtype)
