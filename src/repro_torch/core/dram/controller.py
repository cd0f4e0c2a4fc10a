# Port of src/repro/core/dram/controller.py in torch.  The reference's
# ``lax.scan`` over requests is a Python loop here that carries the state of
# many (trace, params) pairs at once, one a *lane*: ``simulate`` is one
# lane, ``simulate_sweep`` one a workload, ``simulate_grid`` one a (config,
# workload) pair.  The reference's ``lax.cond`` on ``use_villa`` is a
# per-lane ``torch.where``, which is what the reference computes under vmap
# (its ``villa_off`` returns its inputs unchanged).  The scan's ``unroll``
# has no torch meaning and is dropped.  Results also carry the integer
# ``villa_hits`` and ``villa_accesses`` the hit rate is made of.
"""Command-level multi-core memory-controller simulator.

Models the system-level effects the paper evaluates on Ramulator:

  * one channel, N banks; requests gated on bank availability and channel
    occupancy (64 B bursts for reads, full-duration occupancy for memcpy
    copies — LISA/RowClone copies leave the channel free, which is exactly
    the bank-level-parallelism benefit of Sec. 3.1);
  * open-row policy per bank: row hit / row conflict (precharge first, LIP
    shortens it) / closed row;
  * bulk-copy requests dispatched to the configured mechanism
    (memcpy / RC-InterSA / LISA-RISC with real hop distances);
  * optional VILLA fast-subarray cache per bank with the paper's exact policy
    (counters/epochs/benefit replacement), insertions charged to the
    configured copy mechanism (LISA vs RC-InterSA — Fig. 3's comparison).

Mechanism parameters are *data* (:class:`MechanismParams`: the hop-linear
cost coefficients from the :class:`~repro_torch.core.dram.spec`
``CopyMechanism`` registry, LIP precharge latency, VILLA on/off and
fast-tier timings, as 0-d tensors), so one loop serves every copy mechanism
and every ``DramSpec`` preset, and a whole grid of configurations and
workloads runs as the lanes of one loop (:func:`simulate_grid`).  Every
quantity without a serial dependence (hop distances, copy costs, VILLA
hotness) is computed vectorised before the loop; each step is a fixed
sequence of small tensor ops over the lanes, with no host sync.

"Weighted speedup" is reported as in the paper's WS metric [14,93], with each
core's IPC proxied by the reciprocal of its total memory stall time.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core.dram import villa as V
from repro_torch.core.dram.spec import DDR3_1600, DramSpec, get_mechanism
from repro_torch.core.dram.traces import Trace, TraceConfig


@dataclasses.dataclass(frozen=True)
class MechanismConfig:
    copy_mech: str = "memcpy"         # any registered CopyMechanism name
    use_villa: bool = False
    use_lip: bool = False
    villa_copy_mech: str = "lisa"     # lisa | rc_intersa  (Fig. 3 comparison)
    villa: V.VillaConfig = dataclasses.field(default_factory=V.VillaConfig)


class MechanismParams(NamedTuple):
    """Everything the simulator needs, as f32/bool/i32 0-d tensors (or,
    stacked, one entry a config).

    ``copy_*`` / ``ins_*`` are hop-linear cost coefficients
    (``cost(h) = base + per_hop * max(h, 1)``) for the bulk-copy mechanism
    and the VILLA-insertion mechanism; the rest are the spec's access-path
    timings.  Build with :func:`mechanism_params`; stack instances with
    :func:`stack_params`.
    """

    copy_lat_base: torch.Tensor
    copy_lat_hop: torch.Tensor
    copy_e_base: torch.Tensor
    copy_e_hop: torch.Tensor
    copy_on_chan: torch.Tensor     # bool: copy occupies the off-chip channel
    ins_lat_base: torch.Tensor
    ins_lat_hop: torch.Tensor
    ins_e_base: torch.Tensor
    ins_e_hop: torch.Tensor
    use_villa: torch.Tensor        # bool
    t_pre: torch.Tensor            # precharge latency (LIP-shortened or not)
    lat_hit: torch.Tensor
    lat_closed: torch.Tensor
    lat_fast_hit: torch.Tensor
    lat_fast_open: torch.Tensor
    lat_fast_closed: torch.Tensor
    e_hit: torch.Tensor
    e_miss: torch.Tensor
    t_burst: torch.Tensor
    rows_per_subarray: torch.Tensor  # i32


def mechanism_params(mcfg: MechanismConfig, spec: DramSpec = DDR3_1600,
                     device=None) -> MechanismParams:
    """Lower a (spec, config) pair to the data form of the simulator, on
    ``device`` (default: cuda, raising without a GPU)."""
    dev = resolve_device(device)
    copy_m = get_mechanism(mcfg.copy_mech)
    ins_m = get_mechanism(mcfg.villa_copy_mech)
    c_lat0, c_lath, c_e0, c_eh, c_chan = copy_m.coefficients(spec)
    i_lat0, i_lath, i_e0, i_eh, _ = ins_m.coefficients(spec)
    t, e, v = spec.timing, spec.energy, mcfg.villa

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    def flag(x):
        return torch.tensor(bool(x), device=dev)

    return MechanismParams(
        copy_lat_base=f32(c_lat0), copy_lat_hop=f32(c_lath),
        copy_e_base=f32(c_e0), copy_e_hop=f32(c_eh),
        copy_on_chan=flag(c_chan),
        ins_lat_base=f32(i_lat0), ins_lat_hop=f32(i_lath),
        ins_e_base=f32(i_e0), ins_e_hop=f32(i_eh),
        use_villa=flag(mcfg.use_villa),
        t_pre=f32(spec.precharge_latency(mcfg.use_lip)),
        lat_hit=f32(t.tCL),
        lat_closed=f32(t.tRCD + t.tCL),
        lat_fast_hit=f32(v.tCL_fast),
        lat_fast_open=f32(v.tRP_fast + v.tRCD_fast + v.tCL_fast),
        lat_fast_closed=f32(v.tRCD_fast + v.tCL_fast),
        e_hit=f32(e.e_col_internal + e.e_col_channel),
        e_miss=f32(e.e_act_pre + e.e_col_internal + e.e_col_channel),
        t_burst=f32(t.tBURST),
        rows_per_subarray=torch.tensor(spec.rows_per_subarray,
                                       dtype=torch.int32, device=dev),
    )


def simulate_params(trace: Trace, p: MechanismParams, *, n_banks: int,
                    n_cores: int, villa_cfg: V.VillaConfig,
                    is_hot: torch.Tensor | None = None
                    ) -> Dict[str, torch.Tensor]:
    """THE simulator over lanes: ``trace`` fields are (lanes, n) and every
    ``p`` field (lanes,), on one device (a single trace and params, (n,)
    and 0-d, are one lane, and the results then have no lane axis).
    ``is_hot``, the trace's VILLA hotness, is computed here unless given
    (lanes that share a trace share it).

    Per-request quantities with no serial dependence — subarray/hop
    distances, copy costs, and VILLA hotness (``villa.hot_for_sequence``) —
    are precomputed vectorised; the loop carries only the serialised state
    (bank/channel occupancy, open rows, VILLA tags/benefit)."""
    single = trace.t.dim() == 1
    if single:
        trace = Trace(*(x[None] for x in trace))
        p = MechanismParams(*(x.reshape(1) for x in p))
        is_hot = None if is_hot is None else is_hot[None]
    L, n = trace.t.shape
    dev = trace.t.device
    # ---- vectorised precomputation (no serial dependence) ---------------
    col = lambda x: x[:, None]                                # noqa: E731
    sa_v = torch.div(trace.row, col(p.rows_per_subarray),
                     rounding_mode="floor")
    dst_sa_v = torch.div(trace.dst_row, col(p.rows_per_subarray),
                         rounding_mode="floor")
    hops_v = torch.clamp((dst_sa_v - sa_v).abs(), min=1).to(torch.float32)
    copy_lat_v = col(p.copy_lat_base) + col(p.copy_lat_hop) * hops_v
    copy_ene_v = col(p.copy_e_base) + col(p.copy_e_hop) * hops_v
    sa_f = torch.clamp(sa_v, min=1).to(torch.float32)
    ins_lat_v = col(p.ins_lat_base) + col(p.ins_lat_hop) * sa_f
    ins_ene_v = col(p.ins_e_base) + col(p.ins_e_hop) * sa_f
    is_hot_v = (V.hot_for_sequence(trace.bank, trace.row, n_banks, villa_cfg)
                if is_hot is None else is_hot)
    # one (n, lanes) tensor a field: step i reads row i, a view
    xs = [x.transpose(0, 1).contiguous() for x in (
        trace.t, trace.core.long(), trace.bank.long(), trace.row,
        trace.is_copy, is_hot_v, copy_lat_v, copy_ene_v, ins_lat_v,
        ins_ene_v)]

    # the carried state (the reference's SimState), one row a lane
    S = villa_cfg.n_slots
    f32, i32 = torch.float32, torch.int32
    bank_free = torch.zeros((L, n_banks), dtype=f32, device=dev)
    chan_free = torch.zeros((L,), dtype=f32, device=dev)
    open_row = torch.full((L, n_banks), -1, dtype=i32, device=dev)  # -1 closed
    fast_open = torch.full((L, n_banks), -1, dtype=i32, device=dev)
    tags = torch.full((L, n_banks, S), -1, dtype=i32, device=dev)  # VILLA rows
    benefit = torch.zeros((L, n_banks, S), dtype=i32, device=dev)
    core_stall = torch.zeros((L, n_cores), dtype=f32, device=dev)
    energy = torch.zeros((L,), dtype=f32, device=dev)            # uJ
    villa_hits = torch.zeros((L,), dtype=i32, device=dev)
    villa_acc = torch.zeros((L,), dtype=i32, device=dev)
    on = p.use_villa
    acc = on.to(i32)
    lat_conflict = p.t_pre + p.lat_closed
    zero = torch.zeros((), dtype=f32, device=dev)
    minus1 = torch.full((), -1, dtype=i32, device=dev)
    lat_trace = torch.empty((n, L), dtype=f32, device=dev)
    for i in range(n):
        (arrival, core, bank, row, is_copy, is_hot, copy_lat, copy_ene,
         ins_lat, ins_ene) = (x[i] for x in xs)
        b = bank[:, None]
        t0 = torch.maximum(arrival, bank_free.gather(1, b)[:, 0])

        # ---- normal access latency (open-row policy) --------------------
        orow = open_row.gather(1, b)[:, 0]
        is_hit = orow == row
        lat_normal = torch.where(is_hit, p.lat_hit,
                                 torch.where(orow >= 0, lat_conflict,
                                             p.lat_closed))
        e_normal = torch.where(is_hit, p.e_hit, p.e_miss)

        # ---- VILLA (a lane without it keeps its inputs) ------------------
        bs = b[:, :, None].expand(L, 1, S)
        tags_b, ben_b = tags.gather(1, bs)[:, 0], benefit.gather(1, bs)[:, 0]
        new_tags, new_ben, vhit, vinsert = V.tags_access(tags_b, ben_b, row,
                                                         is_hot)
        vhit, vinsert = vhit & on, vinsert & on
        fo = fast_open.gather(1, b)[:, 0]
        # The fast subarray has its own row buffer (it *is* a subarray).
        lat_fast = torch.where(fo == row, p.lat_fast_hit,
                               torch.where(fo >= 0, p.lat_fast_open,
                                           p.lat_fast_closed))
        # An insertion reuses the row buffer the access just activated:
        # the requestor is served at slow latency; the RBM + restore then
        # occupies the *bank* in the background, not the request's
        # critical path.
        lat_normal = torch.where(vhit, lat_fast, lat_normal)
        bank_extra = torch.where(vinsert, ins_lat, zero)
        e_normal = torch.where(
            vhit, p.e_hit,
            torch.where(on, e_normal + torch.where(vinsert, ins_ene, zero),
                        e_normal))
        new_fast = torch.where(vhit | vinsert, row, fo)
        tags.scatter_(1, bs, torch.where(on[:, None], new_tags,
                                         tags_b)[:, None])
        benefit.scatter_(1, bs, torch.where(on[:, None], new_ben,
                                            ben_b)[:, None])
        villa_hits += vhit.to(i32)
        villa_acc += acc

        # ---- bulk copy --------------------------------------------------
        lat = torch.where(is_copy, copy_lat, lat_normal)
        ene = torch.where(is_copy, copy_ene, e_normal)

        # ---- channel occupancy ------------------------------------------
        # Normal reads burst 64 B at the end of the access; memcpy copies own
        # the channel for their whole duration; in-DRAM copies never touch it.
        chan_start_copy = torch.maximum(t0, chan_free)
        t_end_copy = torch.where(p.copy_on_chan, chan_start_copy + lat,
                                 t0 + lat)
        chan_after_copy = torch.where(p.copy_on_chan, t_end_copy, chan_free)
        burst = torch.maximum(t0 + lat - p.t_burst, chan_free)
        t_end_normal = burst + p.t_burst
        t_end = torch.where(is_copy, t_end_copy, t_end_normal)
        chan_free = torch.where(is_copy, chan_after_copy, t_end_normal)

        # A VILLA fast hit is served by the fast subarray and leaves the slow
        # subarrays' row buffer untouched.
        new_open = torch.where(is_copy, minus1,
                               torch.where(vhit, orow, row))
        bank_free.scatter_(1, b, (t_end + bank_extra)[:, None])
        open_row.scatter_(1, b, new_open[:, None])
        fast_open.scatter_(1, b, new_fast[:, None])
        lat_i = t_end - arrival
        core_stall.scatter_add_(1, core[:, None], lat_i[:, None])
        energy = energy + ene
        lat_trace[i] = lat_i
    out = {
        "core_stall": core_stall,
        "energy_uJ": energy,
        # each lane's mean over a contiguous row: the same sum whatever
        # the number of lanes
        "avg_latency_ns": lat_trace.t().contiguous().mean(1),
        "villa_hit_rate": torch.where(
            villa_acc > 0,
            villa_hits / torch.clamp(villa_acc, min=1), zero),
        "villa_hits": villa_hits,
        "villa_accesses": villa_acc,
    }
    return {k: v[0] for k, v in out.items()} if single else out


def simulate(trace: Trace, tcfg: TraceConfig, mcfg: MechanismConfig,
             spec: DramSpec = DDR3_1600) -> Dict[str, torch.Tensor]:
    """Convenience wrapper: lower ``(spec, mcfg)`` to params on the trace's
    device and run the simulator on one lane."""
    return simulate_params(trace, mechanism_params(mcfg, spec,
                                                   trace.t.device),
                           n_banks=tcfg.n_banks, n_cores=tcfg.n_cores,
                           villa_cfg=mcfg.villa)


# The historical name, kept for call sites written against it.
simulate_jit = simulate


def stack_traces(traces: Sequence[Trace]) -> Trace:
    """Stack same-shape traces along a new leading (workload) axis."""
    return Trace(*(torch.stack(xs) for xs in zip(*traces)))


def stack_params(params: Sequence[MechanismParams]) -> MechanismParams:
    """Stack MechanismParams along a new leading (config) axis."""
    return MechanismParams(*(torch.stack(xs) for xs in zip(*params)))


def simulate_sweep(traces: Trace, tcfg: TraceConfig, mcfg: MechanismConfig,
                   spec: DramSpec = DDR3_1600) -> Dict[str, torch.Tensor]:
    """A whole workload sweep: ``traces`` is a stacked Trace (leading axis
    = workloads, see :func:`stack_traces`), one lane a workload.  Results
    gain a leading workload axis."""
    W = traces.t.shape[0]
    p = mechanism_params(mcfg, spec, traces.t.device)
    return simulate_params(traces, MechanismParams(*(x.expand(W) for x in p)),
                           n_banks=tcfg.n_banks, n_cores=tcfg.n_cores,
                           villa_cfg=mcfg.villa)


def simulate_grid(traces: Trace, tcfg: TraceConfig,
                  mcfgs: Sequence[MechanismConfig],
                  spec: DramSpec = DDR3_1600) -> Dict[str, torch.Tensor]:
    """The full cross product in one loop: stacked ``traces`` (workload
    axis) x a list of mechanism configs, one lane a (config, workload)
    pair.  Results carry leading axes ``(len(mcfgs), n_workloads)`` —
    this is the fig3/fig4 "50 workloads x all mechanisms" sweep."""
    villa_cfg = mcfgs[0].villa
    if any(m.villa != villa_cfg for m in mcfgs):
        raise ValueError("simulate_grid requires a shared VillaConfig "
                         "(its table geometry is a static shape)")
    C, W = len(mcfgs), traces.t.shape[0]
    dev = traces.t.device
    params = stack_params([mechanism_params(m, spec, dev) for m in mcfgs])
    lanes_p = MechanismParams(*(x.repeat_interleave(W) for x in params))
    lanes_tr = Trace(*(x.repeat(C, 1) for x in traces))
    hot = V.hot_for_sequence(traces.bank, traces.row, tcfg.n_banks,
                             villa_cfg).repeat(C, 1)
    out = simulate_params(lanes_tr, lanes_p, n_banks=tcfg.n_banks,
                          n_cores=tcfg.n_cores, villa_cfg=villa_cfg,
                          is_hot=hot)
    return {k: v.reshape((C, W) + tuple(v.shape[1:])) for k, v in out.items()}


def weighted_speedup(base_stall: torch.Tensor,
                     mech_stall: torch.Tensor) -> torch.Tensor:
    """WS proxy: mean over cores of IPC_mech/IPC_base with IPC ~ 1/stall.
    Works element-wise over leading batch axes (reduces the last axis)."""
    return (base_stall / torch.clamp(mech_stall, min=1e-3)).mean(dim=-1)
