"""The argument check that int8 K/V share between the attention kernel's
wrapper (``kernels/flash_attention.py``) and its plain versions
(``kernels/ref.py``): int8 K/V come with their (B,T,K) f32 scales, float K/V
with none."""
from __future__ import annotations

from typing import Optional

import torch


def check_scales(k: torch.Tensor, k_scale: Optional[torch.Tensor],
                 v_scale: Optional[torch.Tensor]) -> None:
    """Raise unless int8 K/V come with both (B,T,K) scales and float K/V
    with none."""
    if (k.dtype == torch.int8) != (k_scale is not None) or \
            (k_scale is None) != (v_scale is None):
        raise ValueError(f"int8 K/V take k_scale and v_scale, float K/V "
                         f"neither (got k {k.dtype}, k_scale "
                         f"{k_scale is not None}, v_scale "
                         f"{v_scale is not None})")
    if k_scale is not None and (tuple(k_scale.shape) != tuple(k.shape[:3])
                                or tuple(v_scale.shape) != tuple(k.shape[:3])):
        raise ValueError(f"scales {tuple(k_scale.shape)} / "
                         f"{tuple(v_scale.shape)} do not fit (B,T,K) = "
                         f"{tuple(k.shape[:3])}")
