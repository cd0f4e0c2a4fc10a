# Port of src/repro/models/moe.py:26-120 in torch: init_moe_params,
# _dispatch_indices and moe_block.
"""Mixture-of-Experts with sort-based capacity dispatch.

Dispatch is gather/scatter: within each token group the (token, slot)
entries are sorted by expert id, stably, so each expert takes its tokens in
arrival order, and ranks at or past the capacity C drop (the residual and
the shared experts still apply).  Empty capacity slots hold token 0 with
weight 0, as the reference's do.  The expert products are batched matmuls
over (expert, capacity) tiles.

In a sharding context (``models/sharding.py``) :func:`_moe_split` runs
the reference's expert parallelism over the mesh's folded batch.

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
from repro_torch.models import sharding as SHD
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


def _dispatch(expert_ids: torch.Tensor, n_experts: int, capacity: int,
              prefix: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """expert_ids: (g, T, k) -> (entry (g, E, C) flat indices into T*k, -1
    where empty; valid (g, E, C); place (g, T*k): where entry j sits in
    the flat (E*C) layout, E*C where it dropped).  ``prefix`` (g, E): each
    expert's entries in earlier parts of the routing group, which take its
    capacity first (a group cut over devices)."""
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
    cap = None
    if prefix is not None:
        cap = (capacity - prefix).clamp(min=0)                  # (g, E)
        valid = valid & (torch.arange(capacity, device=flat.device)
                         < cap[..., None])
    entry = torch.gather(order, 1, pos.clamp(0, Tk - 1).reshape(g, -1))
    entry = torch.where(valid, entry.reshape(valid.shape), -1)
    # the inverse: entry j is the rank-th of its expert's entries
    at = torch.empty_like(order)
    at.scatter_(1, order, torch.arange(Tk, device=flat.device).expand(
        g, Tk).contiguous())
    rank = at - torch.gather(starts, 1, flat)
    keep = rank < (capacity if cap is None else torch.gather(cap, 1, flat))
    place = torch.where(keep, flat * capacity + rank, n_experts * capacity)
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
              shared_ff: int = 0, sp: bool = False,
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, M) -> (y, aux_loss).  Router in f32; top-k softmax gating
    normalised over the selected experts; the Switch load-balance loss
    ``E * sum_e f_e p_e`` (None with ``aux_loss=False``: decode has no use
    for it).  In a sharding context: :func:`_moe_split` (``shared_ff``,
    the shared experts' full width, tells their slice from the whole;
    ``sp``: the output goes to the sequence-split layout)."""
    if SHD.active():
        return _moe_split(params, x, top_k, capacity_factor, n_groups,
                          activation, aux_loss, shared_ff, sp)
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


def _moe_split(params: Dict, x: torch.Tensor, k: int, capacity_factor,
               n_groups: int, activation: str, aux_loss: bool,
               shared_ff: int, sp: bool
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`moe_block` over the folded batch of a mesh (the reference's
    expert parallelism, ``moe.py:79-110``).

    The token groups are the reference's, over the GLOBAL batch (its rows
    split over the batch axes in order): a group may lie inside a device's
    rows or span several devices.  Each device routes its own tokens in
    segments that lie in one group and one device; an expert's entries in
    earlier segments of the group (an exclusive prefix of every segment's
    per-expert counts, psum'd over the batch axes) take its capacity
    first, so drops are the reference's.  Experts split over the model
    axis: the devices of a model group hold the same tokens and route them
    alike, and each computes its own experts' entries; the combine's
    partial sums (with the shared experts' ``ff`` slice) reduce over the
    model axis.  The aux loss's two means are psum'd over the batch axes
    before their product."""
    c = SHD.ctx()
    n = c.n
    N, S, M = x.shape
    t_loc = N // n * S
    T = t_loc * c.n_slices
    E = params["router"].shape[-1]
    el = params["wi_gate"].shape[1]
    if n_groups <= 0:
        n_groups = max(min(T // 4096, 64), 1)
    while T % n_groups:
        n_groups -= 1
    G = T // n_groups
    C = max(int(math.ceil(G * k / E * capacity_factor)), min(k, G))
    gs = math.gcd(G, t_loc)
    segs, per = t_loc // gs, G // gs
    dv = x.device

    xt = x.reshape(n, t_loc, M)
    logits = torch.bmm(xt.float(), params["router"])            # (n, t, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)        # (n, t, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    ids = expert_ids.reshape(n * segs, gs, k)
    counts = None
    if per > 1 or aux_loss:
        counts = torch.zeros((n * segs, E), dtype=torch.int64, device=dv)
        counts.scatter_add_(1, ids.reshape(n * segs, -1),
                            torch.ones_like(ids.reshape(n * segs, -1)))
    prefix = None
    if per > 1:                          # a group spans segments
        slices = torch.tensor(c.slice_of, device=dv)
        rows = (slices[:, None] * segs
                + torch.arange(segs, device=dv)).view(n, segs, 1)
        glob = torch.zeros((n, c.n_slices * segs, E), dtype=torch.int64,
                           device=dv)
        glob.scatter_(1, rows.expand(n, segs, E), counts.view(n, segs, E))
        for a in c.batch_axes:
            glob = c.mesh.axis(a).psum(glob)
        grp = glob.view(n, n_groups, per, E)
        excl = (grp.cumsum(2) - grp).view(n, -1, E)
        prefix = torch.gather(excl, 1, rows.expand(n, segs, E)).reshape(
            n * segs, E)
    entry, valid, place = _dispatch(ids, E, C, prefix)          # (ns, E, C)

    # this device's experts: a run of el from its model position
    lo = (SHD.model_index() * el if el < E
          else torch.zeros(n, dtype=torch.int64, device=dv))
    eidx = (lo[:, None] + torch.arange(el, device=dv)).view(n, 1, el, 1)
    pick = lambda t: torch.gather(                  # noqa: E731
        t.view(n, segs, E, C), 2, eidx.expand(n, segs, el, C))
    entry, valid = pick(entry), pick(valid)                     # (n,s,el,C)
    e0 = entry.clamp(min=0)
    token, slot = e0 // k, e0 % k
    an = torch.arange(n, device=dv).view(n, 1, 1, 1)
    sn = torch.arange(segs, device=dv).view(1, segs, 1, 1)
    ein = x.reshape(n, segs, gs, M)[an, sn, token]              # (n,s,el,C,M)
    gv = gate_vals.reshape(n, segs, gs, k)[an, sn, token, slot]
    w = torch.where(valid, gv, torch.zeros((), device=dv))

    h_gate = torch.einsum("nsecm,nemf->nsecf", ein, params["wi_gate"])
    h_up = torch.einsum("nsecm,nemf->nsecf", ein, params["wi_up"])
    if activation == "swiglu":
        act = torch.nn.functional.silu(h_gate)
    else:
        act = torch.nn.functional.gelu(h_gate, approximate="tanh")
    eout = torch.einsum("nsecf,nefm->nsecm", act * h_up, params["wo"])
    eout = eout * w[..., None].to(eout.dtype)

    # the combine: each token's k slots from this device's (el*C) rows, a
    # zero row for a slot dropped or held by another device's expert
    pl = place.view(n, segs * gs * k) - (lo * C)[:, None]
    pl = torch.where((pl >= 0) & (pl < el * C) & (place.view(n, -1)
                                                  < E * C), pl, el * C)
    rows_ = torch.cat([eout.reshape(n, segs * el * C, M),
                       eout.new_zeros((n, 1, M))], dim=1)
    # segment s's rows start at s * el * C
    seg_of = torch.arange(segs, device=dv).repeat_interleave(gs * k)
    flat = torch.where(pl < el * C, pl + (seg_of * el * C)[None],
                       segs * el * C)
    picked = rows_[torch.arange(n, device=dv)[:, None], flat]
    y = picked.reshape(n, t_loc, k, M).sum(dim=2).reshape(N, S, M)

    outs = [(y, el < E)]
    if "shared" in params:
        outs.append((mlp(params["shared"], x, activation),
                     params["shared"]["wo"].shape[-2] < shared_ff))
    part = [t for t, p in outs if p]
    whole = [t for t, p in outs if not p]
    y = None
    for ts, p in ((part, True), (whole, False)):
        if ts:
            r = SHD.reduce_out(sum(ts[1:], ts[0]), p, sp)
            y = r if y is None else y + r
    if not aux_loss:
        return y, None
    me = probs.sum(dim=1)                                       # (n, E)
    fe = counts.view(n, segs, E).sum(1).float()
    for a in c.batch_axes:
        me = c.mesh.axis(a).all_reduce(me)
        fe = c.mesh.axis(a).psum(fe)
    return y, E * torch.sum(fe / (T * k) * (me / T), dim=-1)
