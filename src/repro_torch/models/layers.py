# Port of src/repro/models/layers.py:12-123 in torch.
"""Shared model building blocks: norms, embeddings, MLPs, RoPE and
M-RoPE.

Inside a sharding context (``models/sharding.py``) the MLP's and the
embedding's weights carry the local devices on dim 0: the MLP's matmuls
run per device (column-parallel ``wi_gate``/``wi_up``, row-parallel
``wo``, whose partial sums the caller reduces), the lookup is
vocab-parallel where each device holds a row range of the table, and the
logits come out split over the vocab where the table or head is."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import sharding as SHD

BIG_LEAF = 2**32         # values of a leaf drawn one matrix at a time


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 *statistics*, applied in the input dtype (the
    reference's semantics: ``(1 + scale)`` is cast to x's dtype)."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale).to(x.dtype)


def init_rms(d: int, device=None) -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32,
                       device=resolve_device(device))


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Normal(0, std) with std = fan_in**-0.5 (or ``scale``), drawn from
    ``gen`` on its own device and moved to ``device`` (default: cuda,
    raising without a GPU).  A stacked leaf of more than BIG_LEAF values
    (qwen2-vl-72b's MLP matrices at 32 layers: 7.75 G) is drawn one matrix
    at a time into its output, so that no f32 temporary of the whole leaf
    exists; a smaller one in one draw, scaled in place."""
    device = resolve_device(device)
    fan_in = shape[-2] if len(shape) >= 2 else 1
    std = scale if scale is not None else fan_in ** -0.5
    if len(shape) >= 3 and math.prod(shape) > BIG_LEAF:
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        for m in out.view(-1, *shape[-2:]):
            m.copy_(torch.randn(tuple(shape[-2:]), generator=gen,
                                dtype=torch.float32,
                                device=gen.device).mul_(std))
        return out
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device).mul_(std)
    return w.to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# MLP: SwiGLU / GeGLU gated feed-forward.
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, reps: int = 1,
             dtype=torch.float32, device=None) -> Dict:
    """Stacked (reps, ...) MLP weights, the reference's vmapped layout."""
    device = resolve_device(device)
    return {
        "wi_gate": dense_init(gen, (reps, d_model, d_ff), dtype=dtype,
                              device=device),
        "wi_up": dense_init(gen, (reps, d_model, d_ff), dtype=dtype,
                            device=device),
        "wo": dense_init(gen, (reps, d_ff, d_model), dtype=dtype,
                         device=device),
    }


def mlp(params: Dict, x: torch.Tensor,
        activation: str = "swiglu") -> torch.Tensor:
    """The gated MLP; in a sharding context over each device's ``ff``
    slice, giving its partial sums where the slice is not all of ``ff``."""
    gate = SHD.matmul(x, params["wi_gate"])
    up = SHD.matmul(x, params["wi_up"])
    if activation == "swiglu":
        h = torch.nn.functional.silu(gate) * up
    elif activation == "geglu":
        h = torch.nn.functional.gelu(gate, approximate="tanh") * up
    else:
        raise ValueError(f"unknown activation {activation}")
    return SHD.matmul(h, params["wo"])


# ---------------------------------------------------------------------------
# Rotary position embeddings.
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=resolve_device(device))
                            / head_dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D) rotated by the f32 angles ``ang`` (B, S, D/2): the
    first and second halves of each head are the pairs."""
    d = x.shape[-1]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (D/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                theta: float = 1e4, sections=(2, 1, 1)) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: each head's D/2 frequency bands are cut
    into temporal, height and width sections (``sections`` in proportion,
    the last taking the remainder), each rotated by its own position id.

    x: (B, S, H, D); positions: (3, B, S) int32 — for text the three are
    equal, and the angles are :func:`apply_rope`'s."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (half,)
    total = sum(sections)
    bounds, acc = [], 0
    for s in sections:
        n = half * s // total
        bounds.append((acc, acc + n))
        acc += n
    bounds[-1] = (bounds[-1][0], half)
    ang = torch.cat([pos[..., None].float() * freqs[lo:hi]
                     for (lo, hi), pos in zip(bounds, positions)], dim=-1)
    return _rotate(x, ang)


# ---------------------------------------------------------------------------
# Embedding / LM head.
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d_model: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    # std 1/sqrt(d): the embed-scale multiplier sqrt(d) restores unit variance
    return dense_init(gen, (vocab, d_model), scale=d_model ** -0.5,
                      dtype=dtype, device=device)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          vocab: int = 0) -> torch.Tensor:
    """The rows of ``table`` (V, M) at ``tokens``.  In a sharding context
    ``table`` is (n_local, V', M) and ``tokens`` folded: where V' is less
    than ``vocab`` each device holds its model position's row range,
    looks up the tokens in it and zeros the rest (the partial sums a
    vocab-parallel lookup reduces over the model axis); a whole table
    gives each device's rows whole."""
    if not SHD.active():
        return table[tokens]
    n, V, _ = table.shape
    t = SHD.dev(tokens).long()
    dev = torch.arange(n, device=t.device).view(n, *([1] * (t.dim() - 1)))
    if V == vocab:
        return table[dev, t].flatten(0, 1)
    local = t - SHD.model_index().view_as(dev) * V
    inside = (local >= 0) & (local < V)
    rows = table[dev, local.clamp(0, V - 1)]
    return torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=rows.dtype,
                                   device=rows.device)).flatten(0, 1)


def unembed(table_or_w: torch.Tensor, x: torch.Tensor,
            tied: bool) -> torch.Tensor:
    """``x @ head``, or ``x @ embed.T`` tied; in a sharding context each
    device's (M, V / p) slice, the logits split over the vocab."""
    if SHD.active():
        w = table_or_w.transpose(1, 2) if tied else table_or_w
        return SHD.matmul(x, w)
    w = table_or_w.T if tied else table_or_w
    return x @ w
