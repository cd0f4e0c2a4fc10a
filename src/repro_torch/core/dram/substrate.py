# Port of src/repro/core/dram/substrate.py in torch.  Every command keeps
# the reference's value semantics: it returns a new state and never changes
# its input (a changed leaf is a new tensor; the others are shared).
"""Functional (data-correct) model of a LISA-enabled DRAM bank.

This is the *semantic* half of the reproduction: a state machine whose
operations mirror the DRAM commands the paper reasons about — ACTIVATE /
PRECHARGE / RBM (row buffer movement) / column READ / WRITE — plus the
composed LISA-RISC copy and the 1-to-N multicast enabled by intermediate
row-buffer latching (paper Sec. 5.2).  Geometry and all command costs come
from a :class:`repro_torch.core.dram.spec.DramSpec`; this module guarantees
the *data movement itself* is correct, including the adjacency and
precharge-state preconditions of RBM.  Composed copies return a typed
:class:`CopyResult`.

Subarray, row and line indices are host integers (command schedules are
static); the preconditions that depend on the bank's state (a valid
buffer, a precharged subarray) are device-side selects, as the
reference's masks are, so no command waits on the card.

State layout (one bank):
  cells        (n_subarrays, rows_per_subarray, row_bytes)  uint8
  row_buffer   (n_subarrays, row_bytes)                     uint8
  rb_valid     (n_subarrays,)  bool   — row buffer holds latched data
  open_row     (n_subarrays,)  int32  — activated row id, -1 if precharged
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.dram.spec import DDR3_1600, DramSpec, get_mechanism


class CopyResult(NamedTuple):
    """Typed result of a composed copy: new state + modeled cost.

    Unpacks like the historical ``(state, latency_ns, energy_uj)`` tuple.
    """

    state: "BankState"
    latency_ns: float
    energy_uj: float


@dataclasses.dataclass
class BankState:
    cells: torch.Tensor
    row_buffer: torch.Tensor
    rb_valid: torch.Tensor
    open_row: torch.Tensor

    @property
    def n_subarrays(self) -> int:
        return self.cells.shape[0]

    @property
    def rows_per_subarray(self) -> int:
        return self.cells.shape[1]

    @property
    def row_bytes(self) -> int:
        return self.cells.shape[2]


def make_bank(spec: DramSpec = DDR3_1600, *,
              generator: Optional[torch.Generator] = None,
              device=None) -> BankState:
    """One bank with the spec's geometry on ``device`` (default: cuda,
    raising without a GPU): zeroed cells, or random ones drawn from
    ``generator`` on its own device."""
    dev = resolve_device(device)
    shape = (spec.n_subarrays, spec.rows_per_subarray, spec.row_bytes)
    if generator is None:
        cells = torch.zeros(shape, dtype=torch.uint8, device=dev)
    else:
        cells = torch.randint(0, 256, shape, dtype=torch.uint8,
                              generator=generator,
                              device=generator.device).to(dev)
    return BankState(
        cells=cells,
        row_buffer=torch.zeros((spec.n_subarrays, spec.row_bytes),
                               dtype=torch.uint8, device=dev),
        rb_valid=torch.zeros((spec.n_subarrays,), dtype=torch.bool,
                             device=dev),
        open_row=torch.full((spec.n_subarrays,), -1, dtype=torch.int32,
                            device=dev),
    )


def _set(x: torch.Tensor, index, value) -> torch.Tensor:
    """``x.at[index].set(value)``: a new tensor."""
    y = x.clone()
    y[index] = value
    return y


# ---------------------------------------------------------------------------
# Primitive DRAM commands (pure functions: state -> state).
# ---------------------------------------------------------------------------

def activate(state: BankState, sa: int, row: int) -> BankState:
    """ACTIVATE row ``row`` of subarray ``sa``: latch it into the row buffer.

    If the row buffer already holds *valid* latched data (e.g. after an RBM)
    and the subarray is precharged, activation instead *restores* the buffer
    contents into the target row — this is exactly how LISA-RISC writes the
    moved data into the destination row (paper Sec. 3.1 step 3).
    """
    sa, row = int(sa), int(row)
    restore_mode = state.rb_valid[sa] & (state.open_row[sa] < 0)
    new_buf = torch.where(restore_mode, state.row_buffer[sa],
                          state.cells[sa, row])
    return BankState(
        cells=_set(state.cells, (sa, row), new_buf),
        row_buffer=_set(state.row_buffer, sa, new_buf),
        rb_valid=_set(state.rb_valid, sa, True),
        open_row=_set(state.open_row, sa, row),
    )


def precharge(state: BankState, sa: int) -> BankState:
    """PRECHARGE subarray ``sa``: close the open row, invalidate the buffer."""
    sa = int(sa)
    return BankState(
        cells=state.cells,
        row_buffer=state.row_buffer,
        rb_valid=_set(state.rb_valid, sa, False),
        open_row=_set(state.open_row, sa, -1),
    )


def rbm(state: BankState, src_sa: int, dst_sa: int) -> BankState:
    """Row Buffer Movement between *adjacent* subarrays (the LISA primitive).

    Preconditions: |src-dst| == 1, src buffer valid, dst subarray
    precharged.  On success the activated source row buffer drives the
    precharged destination bitlines; the destination senses and latches
    (paper Sec. 2).  On a violated precondition the destination's data is
    untouched but its buffer is conservatively *invalidated*
    (``rb_valid[dst] = False``): a misfired RBM disturbs the destination
    sense amplifiers, and marking the buffer invalid makes misuse
    detectable by property tests instead of silently keeping stale
    contents trustworthy.
    """
    src_sa, dst_sa = int(src_sa), int(dst_sa)
    ok = (state.rb_valid[src_sa] & (state.open_row[dst_sa] < 0)
          & (abs(src_sa - dst_sa) == 1))
    moved = torch.where(ok, state.row_buffer[src_sa],
                        state.row_buffer[dst_sa])
    return BankState(
        cells=state.cells,
        row_buffer=_set(state.row_buffer, dst_sa, moved),
        rb_valid=_set(state.rb_valid, dst_sa, ok),
        open_row=state.open_row,
    )


def _line_start(line: int, row_bytes: int, spec: DramSpec) -> int:
    """The first byte of cache line ``line``, clamped into the row as
    ``lax.dynamic_slice`` clamps its start."""
    return min(max(int(line) * spec.cache_line_bytes, 0),
               row_bytes - spec.cache_line_bytes)


def read_line(state: BankState, sa: int, line: int,
              spec: DramSpec = DDR3_1600) -> torch.Tensor:
    """Column read of one cache line from the open row buffer."""
    start = _line_start(line, state.row_bytes, spec)
    return state.row_buffer[int(sa), start:start + spec.cache_line_bytes]


def write_line(state: BankState, sa: int, line: int, data: torch.Tensor,
               spec: DramSpec = DDR3_1600) -> BankState:
    """Column write of one cache line into the open row (and buffer).  As
    the reference's, a precharged subarray (open row -1) writes its last
    row."""
    sa = int(sa)
    start = _line_start(line, state.row_bytes, spec)
    buf = state.row_buffer[sa].clone()
    buf[start:start + spec.cache_line_bytes] = data.to(torch.uint8)
    row = int(state.open_row[sa])
    return BankState(
        cells=_set(state.cells, (sa, row), buf),
        row_buffer=_set(state.row_buffer, sa, buf),
        rb_valid=state.rb_valid,
        open_row=state.open_row,
    )


# ---------------------------------------------------------------------------
# Composed operations: LISA-RISC copy, 1-to-N multicast, baselines.
# ---------------------------------------------------------------------------

def _hop_chain(state: BankState, src_sa: int, dst_sa: int) -> BankState:
    """RBM hop-by-hop from src to dst; every intermediate buffer latches."""
    step = 1 if dst_sa >= src_sa else -1
    for cur in range(src_sa, dst_sa, step):
        state = rbm(state, cur, cur + step)
    return state


def lisa_risc_copy(state: BankState, src_sa: int, src_row: int,
                   dst_sa: int, dst_row: int,
                   spec: DramSpec = DDR3_1600) -> CopyResult:
    """Full LISA-RISC row copy.

    ACTIVATE(src) -> RBM x hops -> ACTIVATE(dst, restore mode) -> PRE.
    """
    hops = abs(dst_sa - src_sa)
    if hops < 1:
        raise ValueError("source and destination subarrays must differ")
    state = activate(state, src_sa, src_row)
    state = _hop_chain(state, src_sa, dst_sa)
    state = precharge(state, src_sa)          # close source; dst buffer holds data
    state = activate(state, dst_sa, dst_row)  # restore-mode: buffer -> cells
    state = precharge(state, dst_sa)
    return CopyResult(state, spec.copy_latency("lisa", hops),
                      spec.copy_energy("lisa", hops))


def lisa_broadcast(state: BankState, src_sa: int, src_row: int,
                   dst_sas: Tuple[int, ...], dst_row: int,
                   spec: DramSpec = DDR3_1600) -> CopyResult:
    """1-to-N multicast (paper Sec. 5.2): one hop chain to the farthest
    destination latches the data in *every* intermediate row buffer; a single
    ACTIVATE per destination then restores it into ``dst_row``.

    Latency: one RISC traversal to the farthest destination + one
    (tRAS + tRP) restore per *additional* destination (they are in distinct
    subarrays and proceed back-to-back per the command-level model).
    """
    if src_sa in dst_sas:
        raise ValueError("destination equals source subarray")
    fwd = [d for d in dst_sas if d > src_sa]
    bwd = [d for d in dst_sas if d < src_sa]
    state = activate(state, src_sa, src_row)
    hops = 0
    if fwd:                                   # chain toward max destination
        state = _hop_chain(state, src_sa, max(fwd))
        hops += max(fwd) - src_sa
    if bwd:                                   # chain toward min destination
        state = _hop_chain(state, src_sa, min(bwd))
        hops += src_sa - min(bwd)
    state = precharge(state, src_sa)
    lat = spec.copy_latency("lisa", hops)     # chains serialized (conservative)
    ene = spec.copy_energy("lisa", hops)
    t = spec.timing
    for i, d in enumerate(sorted(dst_sas, key=lambda d: abs(d - src_sa))):
        state = activate(state, d, dst_row)   # restore latched buffer
        state = precharge(state, d)
        if i > 0:
            lat += t.tRAS + t.tRP
            ene += 2 * spec.energy.e_act_pre
    return CopyResult(state, lat, ene)


def _serial_copy(state: BankState, src_sa: int, src_row: int,
                 dst_sa: int, dst_row: int) -> BankState:
    """Data path shared by the serial baselines (RC-InterSA / RC-Bank /
    memcpy): read the source row out through its buffer, write it into the
    destination row.  Only the *cost* differs between those mechanisms."""
    state = activate(state, src_sa, src_row)
    data = state.row_buffer[src_sa]
    state = precharge(state, src_sa)
    state = activate(state, dst_sa, dst_row)
    return BankState(
        cells=_set(state.cells, (dst_sa, dst_row), data),
        row_buffer=_set(state.row_buffer, dst_sa, data),
        rb_valid=state.rb_valid,
        open_row=state.open_row,
    )


def rowclone_intersa_copy(state: BankState, src_sa: int, src_row: int,
                          dst_sa: int, dst_row: int,
                          spec: DramSpec = DDR3_1600) -> CopyResult:
    """Baseline RowClone inter-subarray copy (via the narrow internal bus):
    semantically a row copy; cost from the calibrated Table-1 model."""
    state = precharge(_serial_copy(state, src_sa, src_row, dst_sa, dst_row),
                      dst_sa)
    return CopyResult(state, spec.copy_latency("rc_intersa"),
                      spec.copy_energy("rc_intersa"))


def memcpy_copy(state: BankState, src_sa: int, src_row: int,
                dst_sa: int, dst_row: int,
                spec: DramSpec = DDR3_1600) -> CopyResult:
    """Baseline CPU memcpy: the row crosses the off-chip channel twice (read
    phase + write phase).  Data path as the serial baselines; cost and
    channel occupancy from the ``memcpy`` mechanism."""
    state = precharge(_serial_copy(state, src_sa, src_row, dst_sa, dst_row),
                      dst_sa)
    return CopyResult(state, spec.copy_latency("memcpy"),
                      spec.copy_energy("memcpy"))


def rowclone_bank_copy(state: BankState, src_sa: int, src_row: int,
                       dst_sa: int, dst_row: int,
                       spec: DramSpec = DDR3_1600) -> CopyResult:
    """Baseline RowClone PSM between banks, modeled within one bank state
    (the pipelined internal-bus transfer has the same data semantics; only
    the cost differs)."""
    state = precharge(_serial_copy(state, src_sa, src_row, dst_sa, dst_row),
                      dst_sa)
    return CopyResult(state, spec.copy_latency("rc_bank"),
                      spec.copy_energy("rc_bank"))


def rowclone_intrasa_copy(state: BankState, sa: int, src_row: int,
                          dst_row: int,
                          spec: DramSpec = DDR3_1600) -> CopyResult:
    """Baseline RowClone FPM: back-to-back ACTIVATEs within one subarray
    copy ``src_row`` onto ``dst_row`` through the shared row buffer."""
    state = activate(state, sa, src_row)
    state = BankState(
        cells=_set(state.cells, (sa, dst_row), state.row_buffer[sa]),
        row_buffer=state.row_buffer,
        rb_valid=state.rb_valid,
        open_row=_set(state.open_row, sa, dst_row),
    )
    state = precharge(state, sa)
    return CopyResult(state, spec.copy_latency("rc_intrasa"),
                      spec.copy_energy("rc_intrasa"))


# Functional substrate op per registered mechanism name.  New mechanisms
# (spec.register_mechanism) advertise a data path here via
# register_copy_op; cost-model-only mechanisms simply have no entry.
_COPY_OPS = {}


def register_copy_op(mechanism: str, op) -> None:
    """Attach a functional substrate op ``op(state, src_sa, src_row, dst_sa,
    dst_row, spec) -> CopyResult`` to a registered mechanism name."""
    get_mechanism(mechanism)            # validates the name
    _COPY_OPS[mechanism] = op


def execute_copy(state: BankState, mechanism: str, src_sa: int, src_row: int,
                 dst_sa: int, dst_row: int,
                 spec: DramSpec = DDR3_1600) -> CopyResult:
    """Run one row copy under the named :class:`CopyMechanism` from the
    registry — the functional dispatch point used by benchmarks and demos
    (no string if/elif chains at call sites)."""
    mech = get_mechanism(mechanism)     # validates the name
    op = _COPY_OPS.get(mech.name)
    if op is None:
        raise ValueError(
            f"mechanism {mech.name!r} has no functional substrate op "
            f"(have: {sorted(_COPY_OPS)}); register one with "
            "substrate.register_copy_op")
    if mech.name == "rc_intrasa":
        if src_sa != dst_sa:
            raise ValueError("rc_intrasa copies within one subarray "
                             f"(got {src_sa} -> {dst_sa})")
    elif src_sa == dst_sa:
        raise ValueError(f"{mech.name} requires distinct subarrays")
    return op(state, src_sa, src_row, dst_sa, dst_row, spec)


register_copy_op("lisa", lisa_risc_copy)
register_copy_op("rc_intersa", rowclone_intersa_copy)
register_copy_op("rc_bank", rowclone_bank_copy)
register_copy_op("memcpy", memcpy_copy)
register_copy_op("rc_intrasa",
                 lambda state, src_sa, src_row, dst_sa, dst_row, spec:
                 rowclone_intrasa_copy(state, src_sa, src_row, dst_row, spec))
