# Port of src/repro/models/layers.py:12-123 in torch (M-RoPE, :77-102,
# arrives with the qwen2-vl slice).
"""Shared model building blocks: norms, embeddings, MLPs, RoPE."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import resolve_device


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
    raising without a GPU)."""
    device = resolve_device(device)
    fan_in = shape[-2] if len(shape) >= 2 else 1
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device) * std
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
    gate = x @ params["wi_gate"]
    up = x @ params["wi_up"]
    if activation == "swiglu":
        h = torch.nn.functional.silu(gate) * up
    elif activation == "geglu":
        h = torch.nn.functional.gelu(gate, approximate="tanh") * up
    else:
        raise ValueError(f"unknown activation {activation}")
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# Rotary position embeddings.
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=resolve_device(device))
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                        # (D/2,)
    ang = positions[..., None].float() * freqs                    # (B, S, D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head.
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d_model: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    # std 1/sqrt(d): the embed-scale multiplier sqrt(d) restores unit variance
    return dense_init(gen, (vocab, d_model), scale=d_model ** -0.5,
                      dtype=dtype, device=device)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(table_or_w: torch.Tensor, x: torch.Tensor,
            tied: bool) -> torch.Tensor:
    w = table_or_w.T if tied else table_or_w
    return x @ w
