# Port of src/repro/models/rwkv.py in torch: init_rwkv_params, _shift,
# _wkv_scan, rwkv_time_mix and rwkv_channel_mix (lm.init_cache holds the
# state leaves).
"""RWKV-6 ("Finch") blocks: attention-free time-mix with data-dependent
decay, and the squared-ReLU channel-mix.

The state is O(1) in context length: per block a (B, H, 64, 64) f32 wkv
matrix and two token-shift vectors in the cache's dtype.  The wkv
recurrence runs as a plain step loop over time; the reference chunks and
rematerialises it (``rwkv.py:97-100``), which only changes what its
backward pass keeps.

In a sharding context (``models/sharding.py``) the time mix runs over
each device's heads (the reference's split, its ``rwkv.py:124``): ``wk``,
``wv``, ``wr``, ``wg``, ``w2``, ``w0``, ``u`` and ``ln_x`` are the
device's head columns, ``wo`` its rows (a partial output, which the caller
reduces), and the per-head group norm and the ``wkv`` state stay local.
The channel mix splits ``ff`` (its ``rwkv.py:149``): ``cm_wk``
column-parallel, ``cm_wv`` row-parallel and summed over the model axis,
and the gate ``cm_wr`` whole, so its output is whole on every device.
The mixing weights and ``w1`` are whole.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import sharding as SHD
from repro_torch.models.layers import dense_init

HEAD_DIM = 64
DECAY_LORA = 64


class RWKVState(NamedTuple):
    att_shift: Optional[torch.Tensor]   # (B, d_model): previous token (time-mix)
    ffn_shift: Optional[torch.Tensor]   # (B, d_model): previous token (channel-mix)
    wkv: Optional[torch.Tensor]         # (B, H, D, D) f32: key-value state


def init_rwkv_params(gen: torch.Generator, d_model: int, d_ff: int,
                     reps: int = 1, dtype=torch.float32, device=None) -> Dict:
    """Stacked (reps, ...) time-mix and channel-mix weights on ``device``
    (default: cuda, raising without a GPU), drawn as the reference's; the
    mixing weights ``mu_*``, ``cm_mu_*``, the decay base ``w0``, the bonus
    ``u`` and ``ln_x`` stay f32 whatever ``dtype`` is."""
    device = resolve_device(device)
    H = d_model // HEAD_DIM

    def w(shape, scale=None, dt=dtype):
        return dense_init(gen, (reps,) + shape, scale=scale, dtype=dt,
                          device=device)

    def full(value):
        return torch.full((reps, d_model), value, dtype=torch.float32,
                          device=device)

    return {
        "mu_w": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
        "mu_r": full(0.5), "mu_g": full(0.5),
        # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(xw@w1)@w2))
        "w0": full(-6.0),
        "w1": w((d_model, DECAY_LORA)),
        "w2": w((DECAY_LORA, d_model), scale=DECAY_LORA ** -0.5),
        "u": w((H, HEAD_DIM), scale=1.0, dt=torch.float32),
        "wk": w((d_model, d_model)),
        "wv": w((d_model, d_model)),
        "wr": w((d_model, d_model)),
        "wg": w((d_model, d_model)),
        "wo": w((d_model, d_model)),
        "ln_x": full(1.0),
        "cm_mu_k": full(0.5), "cm_mu_r": full(0.5),
        "cm_wk": w((d_model, d_ff)),
        "cm_wv": w((d_ff, d_model)),
        "cm_wr": w((d_model, d_model)),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: x[t-1] (zeros, or the carried token cast to x's dtype,
    at t = 0)."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None, :].to(x.dtype), x], dim=1)[:, :-1]


def _wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence, one step a token.  r,k,v: (B,S,H,D) f32; w:
    (B,S,H,D) decay in (0,1); u: (H,D).

    out_t = r_t . (S_{t-1} + u * k_t v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T

    At S == 1 (decode) this is the reference's single step (its
    ``rwkv.py:88``).  In a sharding context u is each device's (n_local,
    H, D).  Returns (out (B,S,H,D), the final state)."""
    B, S, H, D = r.shape
    s = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
         if state is None else state)
    u = SHD.rows(u, B)[..., None]
    outs = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # (B,H,Dk,Dv)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + u * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def rwkv_time_mix(params: Dict, x: torch.Tensor, *,
                  state: Optional[RWKVState] = None
                  ) -> Tuple[torch.Tensor,
                             Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """x: (B,S,M).  Returns (y, None) without a state, else (y, (the last
    token, the new wkv state))."""
    B, S, _ = x.shape
    xs = _shift(x, state.att_shift if state is not None else None)

    def mix(mu):
        return (x + SHD.mul(xs - x, mu)).to(x.dtype)

    xw, xk, xv, xr, xg = (mix(params[f"mu_{n}"]) for n in "wkvrg")
    # data-dependent per-channel decay, in f32 (the device's channels)
    dd = SHD.add(SHD.matmul(torch.tanh(SHD.matmul(xw, params["w1"])).float(),
                            params["w2"].float()), params["w0"])
    w = torch.exp(-torch.exp(torch.clamp(dd, -20.0, 1.0)))       # (B,S,Ml)
    ml = w.shape[-1]
    H = ml // HEAD_DIM

    k = SHD.matmul(xk, params["wk"]).reshape(B, S, H, HEAD_DIM)
    v = SHD.matmul(xv, params["wv"]).reshape(B, S, H, HEAD_DIM)
    r = SHD.matmul(xr, params["wr"]).reshape(B, S, H, HEAD_DIM)
    g = F.silu(SHD.matmul(xg, params["wg"]))

    out, new_wkv = _wkv_scan(r.float(), k.float(), v.float(),
                             w.reshape(B, S, H, HEAD_DIM), params["u"],
                             state.wkv if state is not None else None)
    # per-head group norm, with the population variance
    mean = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, correction=0)
    out = (out - mean) * torch.rsqrt(var + 64e-5)
    out = SHD.mul(out.reshape(B, S, ml), params["ln_x"])
    y = SHD.matmul(out.to(x.dtype) * g, params["wo"])
    if state is None:
        return y, None
    return y, (x[:, -1, :], new_wkv)


def rwkv_channel_mix(params: Dict, x: torch.Tensor,
                     state: Optional[RWKVState] = None, ff: int = 0
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Squared-ReLU channel mix; returns (y, the last token or None).
    ``ff``, the full ``d_ff``, tells a split ``cm_wv`` from a whole one."""
    xs = _shift(x, state.ffn_shift if state is not None else None)
    xk = x + SHD.mul(xs - x, params["cm_mu_k"])
    xr = x + SHD.mul(xs - x, params["cm_mu_r"])
    k = torch.square(F.relu(SHD.matmul(xk.to(x.dtype), params["cm_wk"])))
    v = SHD.psum_split(SHD.matmul(k, params["cm_wv"]),
                       params["cm_wv"].shape[-2] < ff)
    y = torch.sigmoid(SHD.matmul(xr.to(x.dtype), params["cm_wr"])) * v
    return y, (x[:, -1, :] if state is not None else None)
