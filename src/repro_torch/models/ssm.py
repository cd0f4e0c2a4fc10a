# Port of src/repro/models/ssm.py in torch: init_mamba_params, _ssm_scan,
# _conv_causal and mamba_block (lm.init_cache holds the state leaves).
"""Mamba (selective SSM) block: the Jamba hybrid's attention-free mixer.

The selective scan runs as a plain step loop over time.  The reference
chunks and rematerialises it (``ssm.py:51-85``), which only changes what its
backward pass keeps; the forward values are the same steps in the same
order.  Decode is the single-step closed form with a rolling conv buffer, so
the state is constant in context length.  The ``ssm`` state stays f32
whatever the weights' dtype; the conv history takes the cache's.

In a sharding context (``models/sharding.py``) the block runs over each
device's ``inner`` channels, the reference's split (its ``ssm.py:111``):
``in_proj`` is the device's ``x_in`` and ``z`` columns side by side,
``conv_*``, ``dt_w``, ``dt_bias``, ``A_log`` and ``D`` its channels, and
``x_proj`` and ``out_proj`` its rows, so ``dt_r``, ``B`` and ``C`` are
summed over the model axis before the scan and the output is the
device's partial sum, which the caller reduces.  The ``conv`` and ``ssm``
state is the device's own channels.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import sharding as SHD
from repro_torch.models.layers import dense_init


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, d_inner): last inputs of the conv
    ssm: torch.Tensor    # (B, d_inner, d_state), f32


def init_mamba_params(gen: torch.Generator, d_model: int, d_state: int = 16,
                      d_conv: int = 4, expand: int = 2, reps: int = 1,
                      dtype=torch.float32, device=None) -> Dict:
    """Stacked (reps, ...) Mamba weights on ``device`` (default: cuda,
    raising without a GPU), drawn as the reference's: ``dt_bias`` is the
    inverse softplus of a log-uniform step in [0.001, 0.1]; ``A_log``,
    ``D`` and ``dt_bias`` stay f32 whatever ``dtype`` is."""
    device = resolve_device(device)
    d_inner = expand * d_model
    dt_rank = math.ceil(d_model / 16)

    def w(shape, scale=None):
        return dense_init(gen, (reps,) + shape, scale=scale, dtype=dtype,
                          device=device)

    u = torch.rand((reps, d_inner), generator=gen, dtype=torch.float32,
                   device=gen.device).to(device)
    dt = torch.clamp(torch.exp(u * (math.log(0.1) - math.log(0.001))
                               + math.log(0.001)), min=1e-4)
    A = torch.arange(1, d_state + 1, dtype=torch.float32,
                     device=device).expand(reps, d_inner, d_state)
    return {
        "in_proj": w((d_model, 2 * d_inner)),
        "conv_w": w((d_conv, d_inner), scale=d_conv ** -0.5),
        "conv_b": torch.zeros((reps, d_inner), dtype=dtype, device=device),
        "x_proj": w((d_inner, dt_rank + 2 * d_state)),
        "dt_w": w((dt_rank, d_inner), scale=dt_rank ** -0.5),
        "dt_bias": torch.log(torch.expm1(dt)),
        "A_log": torch.log(A).contiguous(),
        "D": torch.ones((reps, d_inner), dtype=torch.float32, device=device),
        "out_proj": w((d_inner, d_model)),
    }


def _ssm_scan(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
              xs: torch.Tensor, A: torch.Tensor,
              h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan, one step a token: ``h = exp(dt A) h + (dt x) B``,
    ``y = h . C``.  dt/xs: (B,S,D), Bm/Cm: (B,S,N), A: (D,N), all f32.
    Returns (y (B,S,D), h_final (B,D,N)).  In a sharding context A is
    each device's (n_local, D, N)."""
    B, S, D = xs.shape
    h = (torch.zeros((B, D, A.shape[-1]), dtype=torch.float32,
                     device=xs.device) if h0 is None else h0.float())
    A = SHD.rows(A, B)
    ys = []
    for t in range(S):
        h = (torch.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * xs[:, t])[..., None] * Bm[:, t, None, :])
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h


def _conv_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over time.  x: (B,S,D), w: (K,D); the history
    (B,K-1,D) is cast to x's dtype, zeros without one.  In a sharding
    context w and b are each device's, (n_local, K, D) and (n_local,
    D)."""
    K, S = w.shape[-2], x.shape[1]
    if history is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([history.to(x.dtype), x], dim=1)
    out = 0
    for i in range(K):                 # the reference's sum, in its order
        out = out + SHD.mul(xp[:, i:i + S, :], w.select(-2, i))
    return SHD.add(out, b)


def mamba_block(params: Dict, x: torch.Tensor, *, d_state: int, d_conv: int,
                expand: int, state: Optional[MambaState] = None
                ) -> Tuple[torch.Tensor, Optional[MambaState]]:
    """x: (B,S,M).  Three branches, as the reference's: no state (train,
    forward), the S == 1 closed form from a state (decode) and the scan
    from a state (prefill).  Returns (y, the new state or None); the new
    conv history is in the promoted dtype of the old one and x's."""
    B, S, M = x.shape
    dt_rank = params["dt_w"].shape[-2]
    x_in, z = torch.chunk(SHD.matmul(x, params["in_proj"]), 2, dim=-1)

    if state is None:
        xc = _conv_causal(x_in, params["conv_w"], params["conv_b"])
        new_conv = None
    else:
        xc = _conv_causal(x_in, params["conv_w"], params["conv_b"],
                          history=state.conv)
        new_conv = torch.cat([state.conv, x_in.to(torch.promote_types(
            state.conv.dtype, x_in.dtype))], dim=1)[:, -(d_conv - 1):]
    xc = F.silu(xc)

    x_db = SHD.psum_split(SHD.matmul(xc, params["x_proj"]),
                          params["x_proj"].shape[-2] < expand * M)
    dt_r = x_db[..., :dt_rank]
    Bm = x_db[..., dt_rank:dt_rank + d_state].float()
    Cm = x_db[..., dt_rank + d_state:].float()
    dt = F.softplus(SHD.add(SHD.matmul(dt_r, params["dt_w"]).float(),
                            params["dt_bias"]))
    A = -torch.exp(params["A_log"])

    if state is None:
        y, _ = _ssm_scan(dt, Bm, Cm, xc.float(), A)
        new_state = None
    elif S == 1:
        h = (torch.exp(dt[:, 0, :, None] * SHD.rows(A, B)) * state.ssm
             + (dt[:, 0] * xc[:, 0].float())[..., None] * Bm[:, 0, None, :])
        y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None, :]
        new_state = MambaState(conv=new_conv, ssm=h)
    else:                                       # prefill: scan from state
        y, h = _ssm_scan(dt, Bm, Cm, xc.float(), A, h0=state.ssm)
        new_state = MambaState(conv=new_conv, ssm=h)

    y = (y + SHD.mul(xc.float(), params["D"])).to(x.dtype)
    y = y * F.silu(z)
    return SHD.matmul(y, params["out_proj"]), new_state
