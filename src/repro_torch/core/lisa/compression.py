# Port of src/repro/core/lisa/compression.py:17-48 in torch: compress,
# decompress and init_error on one device, and allreduce_mean_compressed
# (:30-44) over a mesh axis object (repro_torch/launch/mesh.py).
"""Error-feedback int8 gradient compression for the data-parallel axis.

A 1000+-node requirement: gradient all-reduce bandwidth.  Per-tensor absmax
int8 quantization with local error feedback (residual carried to the next
step) keeps convergence while cutting DP collective bytes 2x vs bf16 / 4x vs
fp32.  ``torch.round``, like ``jnp.round``, rounds half to even.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.optim.adamw import tree_map


def compress(g: torch.Tensor, err: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize ``g + err`` to int8.  Returns (q, scale, new_err)."""
    target = g.to(torch.float32) + err
    scale = torch.clamp(target.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
    new_err = target - q.to(torch.float32) * scale
    return q, scale, new_err


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def allreduce_mean_compressed(g: torch.Tensor, err: torch.Tensor, axis
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DP gradient mean with int8 payload + error feedback over ``axis``.

    ``g``/``err``: (local, ...) with the axis's local devices on dim 0.
    The int32 sum is exact for <= 2^23 devices; the shared scale is the max
    across the axis (``pmax``) so all devices dequantize identically.
    """
    target = g.to(torch.float32) + err
    local_max = target.abs().reshape(target.shape[0], -1).amax(1)
    scale = torch.clamp(axis.pmax(local_max), min=1e-12) / 127.0
    scale = scale.view((-1,) + (1,) * (target.dim() - 1))
    q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
    new_err = target - q.to(torch.float32) * scale
    total = axis.psum(q.to(torch.int32))
    return (total.to(torch.float32) * scale / axis.size).to(g.dtype), new_err


def init_error(params) -> dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
