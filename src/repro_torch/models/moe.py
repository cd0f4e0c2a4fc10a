# Port of src/repro/models/moe.py:26-120 in torch: init_moe_params,
# _dispatch_indices and moe_block.
"""Mixture-of-Experts with sort-based capacity dispatch.

Dispatch is gather/scatter: within each token group the (token, slot)
entries are sorted by expert id, stably, so each expert takes its tokens in
arrival order, and ranks at or past the capacity C drop (the residual and
the shared experts still apply).  Empty capacity slots hold token 0 with
weight 0, as the reference's do.  The expert products are batched matmuls
over (expert, capacity) tiles.

The combine is deterministic: where the reference scatter-adds each
expert's outputs into their tokens (``y.at[token].add``), whose float sum a
card would run in atomic order, each token here gathers its k slots' outputs
and sums them in one fixed order, so the same inputs give the same bits on
every run.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models.layers import dense_init, init_mlp, mlp


def _expert_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """A stacked (reps, E, rows, cols) expert leaf drawn as the reference's
    ``dense_init`` draws an (E, rows, cols) one, whose fan-in is its first
    dim: std E**-0.5.  It is drawn one (rows, cols) matrix at a time, so
    that no f32 temporary of the whole leaf exists (deepseek-v2's experts
    are 10 G values a leaf at 8 layers)."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    flat = out.view(-1, *shape[-2:])
    for i in range(flat.shape[0]):
        flat[i] = dense_init(gen, shape[-2:], scale=shape[1] ** -0.5,
                             dtype=dtype, device=device)
    return out


def init_moe_params(gen: torch.Generator, d_model: int, n_experts: int,
                    d_ff_expert: int, n_shared: int, reps: int = 1,
                    dtype=torch.float32, device=None) -> Dict:
    """Stacked (reps, ...) router, expert and shared-expert weights on
    ``device`` (default: cuda, raising without a GPU).  The router stays
    f32 whatever ``dtype`` is, as the reference's."""
    device = resolve_device(device)
    p = {
        "router": dense_init(gen, (reps, d_model, n_experts),
                             scale=d_model ** -0.5, dtype=torch.float32,
                             device=device),
        "wi_gate": _expert_init(gen, (reps, n_experts, d_model, d_ff_expert),
                                dtype, device),
        "wi_up": _expert_init(gen, (reps, n_experts, d_model, d_ff_expert),
                              dtype, device),
        "wo": _expert_init(gen, (reps, n_experts, d_ff_expert, d_model),
                           dtype, device),
    }
    if n_shared > 0:
        p["shared"] = init_mlp(gen, d_model, n_shared * d_ff_expert, reps,
                               dtype, device)
    return p


def _dispatch(expert_ids: torch.Tensor, n_experts: int, capacity: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """expert_ids: (g, T, k) -> (entry (g, E, C) flat indices into T*k, -1
    where empty; valid (g, E, C); place (g, T*k): where entry j sits in
    the flat (E*C) layout, E*C where it dropped)."""
    g, T, k = expert_ids.shape
    Tk = T * k
    flat = expert_ids.reshape(g, Tk)
    order = torch.argsort(flat, dim=-1, stable=True)
    sorted_e = torch.gather(flat, 1, order)
    experts = torch.arange(n_experts, device=flat.device,
                           dtype=flat.dtype).expand(g, n_experts).contiguous()
    starts = torch.searchsorted(sorted_e, experts, side="left")
    ends = torch.searchsorted(sorted_e, experts, side="right")
    pos = starts[..., None] + torch.arange(capacity, device=flat.device)
    valid = pos < ends[..., None]                               # (g, E, C)
    entry = torch.gather(order, 1, pos.clamp(0, Tk - 1).reshape(g, -1))
    entry = torch.where(valid, entry.reshape(valid.shape), -1)
    # the inverse: entry j is the rank-th of its expert's entries
    at = torch.empty_like(order)
    at.scatter_(1, order, torch.arange(Tk, device=flat.device).expand(
        g, Tk).contiguous())
    rank = at - torch.gather(starts, 1, flat)
    place = torch.where(rank < capacity, flat * capacity + rank,
                        n_experts * capacity)
    return entry, valid, place


def _dispatch_indices(expert_ids: torch.Tensor, n_experts: int,
                      capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """expert_ids: (T, k) -> (entry (E, C) flat indices into T*k, valid
    (E, C)).  Tokens are ranked by (expert, arrival order); ranks >=
    capacity drop."""
    entry, valid, _ = _dispatch(expert_ids[None], n_experts, capacity)
    return entry[0], valid[0]


def moe_block(params: Dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, n_groups: int = 0,
              activation: str = "swiglu", aux_loss: bool = True,
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, M) -> (y, aux_loss).  Router in f32; top-k softmax gating
    normalised over the selected experts; the Switch load-balance loss
    ``E * sum_e f_e p_e`` (None with ``aux_loss=False``: decode has no use
    for it)."""
    B, S, M = x.shape
    T = B * S
    E = params["wi_gate"].shape[0]
    if n_groups <= 0:
        n_groups = max(min(T // 4096, 64), 1)
    while T % n_groups:
        n_groups -= 1
    G = T // n_groups
    k = top_k
    C = max(int(math.ceil(G * k / E * capacity_factor)), min(k, G))

    xt = x.reshape(n_groups, G, M)
    logits = xt.float() @ params["router"]                      # (g, G, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)        # (g, G, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    entry, valid, place = _dispatch(expert_ids, E, C)           # (g, E, C)
    e0 = entry.clamp(min=0)
    token, slot = e0 // k, e0 % k
    grp = torch.arange(n_groups, device=x.device)[:, None, None]
    ein = xt[grp, token]                                        # (g, E, C, M)
    w = torch.where(valid, gate_vals[grp, token, slot],
                    torch.zeros((), device=x.device))           # (g, E, C)

    h_gate = torch.einsum("gecm,emf->gecf", ein, params["wi_gate"])
    h_up = torch.einsum("gecm,emf->gecf", ein, params["wi_up"])
    if activation == "swiglu":
        act = torch.nn.functional.silu(h_gate)
    else:
        act = torch.nn.functional.gelu(h_gate, approximate="tanh")
    eout = torch.einsum("gecf,efm->gecm", act * h_up, params["wo"])
    eout = eout * w[..., None].to(eout.dtype)

    # the combine: token t's k slots from the flat (E*C) rows, a zero row
    # for a dropped slot, summed over k in one fixed order
    rows = torch.cat([eout.reshape(n_groups, E * C, M),
                      eout.new_zeros((n_groups, 1, M))], dim=1)
    picked = rows[torch.arange(n_groups, device=x.device)[:, None], place]
    y = picked.reshape(n_groups, G, k, M).sum(dim=2).reshape(B, S, M)

    if "shared" in params:
        y = y + mlp(params["shared"], x, activation)
    if not aux_loss:
        return y, None
    me = probs.mean(dim=(0, 1))                                 # (E,)
    fe = torch.bincount(expert_ids.reshape(-1), minlength=E).float() / (
        T * k)
    return y, E * torch.sum(fe * me)
