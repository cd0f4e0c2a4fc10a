# Port of src/repro/core/dram/spec.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""`DramSpec` — the single device-model API for the LISA reproduction.

Everything the substrate, controller, traces, benchmarks, and the TPU-side
analogy need to know about a DRAM device lives in one immutable value:

  * geometry      — ``n_subarrays`` / ``rows_per_subarray`` / ``row_bytes``
                    (+ ``cache_line_bytes``), used by ``substrate.make_bank``
                    and ``traces.generate``;
  * timing        — JEDEC-style command timings (``DramTiming``) plus the
                    LISA SPICE-derived constants (``LisaTiming``);
  * energy        — the calibrated per-component model (``EnergyModel``);
  * channel       — off-chip channel bandwidth, for the Sec. 2 ratio claim.

Copy mechanisms (memcpy / RowClone variants / LISA-RISC) are *objects* in a
registry, not string ``if/elif`` chains.  Each ``CopyMechanism`` exposes its
cost as a hop-linear model ``cost(h) = base + per_hop * max(h, 1)`` —
coefficients that lower to **traced data**: ``controller.mechanism_params``
feeds them to the single jitted ``simulate`` (no recompiling per mechanism
via ``static_argnums``), and ``mechanism_table`` offers the same lowering as
one dense ``(n_mechanisms, 5)`` array for sweeps indexed by ``mech_id``.

``DDR3_1600`` is the calibrated default: its ``table1()`` reproduces the
paper's Table 1 exactly (148.5 / 196.5 / 260.5 ns and 0.09 / 0.12 / 0.17 uJ
for LISA-RISC-1/7/15; 1363.75 ns / 4.33 uJ for RC-InterSA).  Other presets
(``DDR4_2400``, ``LPDDR4_3200``) carry the same LISA/energy calibration over
plausible interface timings for geometry/timing sensitivity sweeps; the
DRAM<->TPU analogy is made literal by ``core.lisa.topology.ici_dram_spec``,
which expresses the ICI mesh as just another ``DramSpec`` instance.

Units: nanoseconds (ns) and microjoules (uJ) throughout.  See DESIGN.md
Sec. 5 for the modeling assumptions and Sec. 6 for this API.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Component models.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DramTiming:
    """JEDEC-style command timings, in ns (defaults: DDR3-1600 11-11-11)."""

    tCK: float = 1.25
    tRCD: float = 13.75     # ACT -> column command
    tRP: float = 13.75      # PRE -> ACT (baseline precharge latency)
    tRAS: float = 35.0      # ACT -> PRE (restoration complete)
    tCL: float = 13.75      # column read latency
    tCWL: float = 12.5      # column write latency (CWL=10)
    tCCD: float = 5.0       # column-to-column, 4 cycles
    tBURST: float = 5.0     # 8-beat burst, 4 cycles
    tWR: float = 15.0       # write recovery
    tRTP: float = 7.5       # read -> precharge
    tREFI: float = 7800.0   # average refresh interval (64 ms / 8192 rows)
    tRFC: float = 260.0     # all-bank refresh cycle time (4 Gb density)

    @property
    def tRC(self) -> float:
        return self.tRAS + self.tRP

    def __post_init__(self):
        if not 0.0 < self.tRFC < self.tREFI:
            raise ValueError(
                f"tRFC ({self.tRFC}) must be positive and shorter than "
                f"tREFI ({self.tREFI}) — the device must spend most of its "
                f"time NOT refreshing")


@dataclasses.dataclass(frozen=True)
class LisaTiming:
    """LISA-specific timings from the paper's SPICE evaluation.

    * ``t_rbm_hop`` — per-hop increment of a LISA-RISC copy.  Table 1:
      (260.5 - 148.5) / 14 hops = 8 ns/hop exactly.
    * ``t_rbm_row`` — time for one RBM row-buffer movement used for the
      bandwidth claim: 8 KB / 500 GB/s = 16.384 ns (includes the paper's
      conservative 60% margin).
    * ``sense_margin`` — hop-independent part of LISA-RISC beyond
      ACT/ACT/PRE.  Back-solved: 148.5 - 8 = 140.5;
      margin = 140.5 - (35+35+13.75) = 56.75.
    * ``t_pre_linked`` — LISA-LIP precharge: 13 ns -> 5 ns (2.6x, Sec. 3.3).
    """

    t_rbm_hop: float = 8.0
    t_rbm_row: float = 16.384
    sense_margin: float = 56.75
    t_pre_baseline: float = 13.0
    t_pre_linked: float = 5.0

    def risc_base(self, t: DramTiming) -> float:
        """Hop-independent LISA-RISC latency: ACT(src) + ACT(dst) + PRE."""
        return t.tRAS + t.tRAS + t.tRP + self.sense_margin


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """Component energy model (uJ), back-solved from Table 1 anchors.

    * ``e_act_pre`` — one ACT(+share of PRE) row operation.  RC-IntraSA does
      ACT->ACT->PRE and costs 0.06 uJ  =>  0.03 per row op (2 row ops).
    * ``e_col_internal`` — one 64 B column transfer over the internal bus.
      RC-Bank = 4 row ops + 256 col ops = 2.08  =>  (2.08-0.12)/256.
    * ``e_intersa_extra`` — extra global-bus/driver energy of RowClone
      inter-subarray serial mode (calibrated so RC-InterSA = 4.33 exactly).
    * ``e_col_channel`` — extra channel+I/O energy per 64 B transfer for
      memcpy: 128 lines out + 128 lines back = 256 channel transfers;
      (6.2 - 4.33) / 256 ~= 14.3 pJ/bit, in line with DDR3 I/O energy.
    * ``e_risc_base`` / ``e_rbm_hop`` — LISA-RISC energy: 0.09 at 1 hop,
      +0.08/14 per extra hop (Table 1: 0.09 / 0.12 / 0.17 at 1/7/15 hops).
    """

    e_act_pre: float = 0.03
    e_col_internal: float = (2.08 - 0.12) / 256.0
    e_intersa_extra: float = 4.33 - (0.12 + 512 * (2.08 - 0.12) / 256.0)
    e_col_channel: float = (6.2 - 4.33) / 256.0
    e_risc_base: float = 0.09
    e_rbm_hop: float = 0.08 / 14.0


# ---------------------------------------------------------------------------
# The device model.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DramSpec:
    """One DRAM device: geometry + timing/energy preset + channel.

    Immutable and hashable, so a spec can be a jit static argument; all
    *swept* quantities are lowered to traced data via ``mechanism_table`` /
    ``controller.mechanism_params`` instead.
    """

    name: str = "DDR3_1600"
    n_subarrays: int = 16
    rows_per_subarray: int = 64
    row_bytes: int = 8192                 # 8 KB DRAM row (rank-level)
    cache_line_bytes: int = 64
    timing: DramTiming = dataclasses.field(default_factory=DramTiming)
    lisa: LisaTiming = dataclasses.field(default_factory=LisaTiming)
    energy: EnergyModel = dataclasses.field(default_factory=EnergyModel)
    channel_bw_gbps: float = 19.2         # DDR4-2400 x64 channel (Sec. 2)

    # ---- geometry ----------------------------------------------------------
    @property
    def lines_per_row(self) -> int:
        return self.row_bytes // self.cache_line_bytes

    @property
    def n_rows(self) -> int:
        """Rows per bank (across all subarrays)."""
        return self.n_subarrays * self.rows_per_subarray

    @property
    def rbm_bw_gbps(self) -> float:
        """RBM bandwidth: bytes/ns == GB/s (500.0 for the default preset)."""
        return self.row_bytes / self.lisa.t_rbm_row

    def with_geometry(self, n_subarrays: int | None = None,
                      rows_per_subarray: int | None = None,
                      row_bytes: int | None = None) -> "DramSpec":
        """A copy of this spec with some geometry fields replaced."""
        return dataclasses.replace(
            self,
            n_subarrays=n_subarrays or self.n_subarrays,
            rows_per_subarray=rows_per_subarray or self.rows_per_subarray,
            row_bytes=row_bytes or self.row_bytes,
        )

    # ---- copy-mechanism costs ---------------------------------------------
    def copy_latency(self, mechanism: str, hops: int = 1) -> float:
        return get_mechanism(mechanism).latency(self, hops)

    def copy_energy(self, mechanism: str, hops: int = 1) -> float:
        return get_mechanism(mechanism).energy(self, hops)

    def copy_cost(self, mechanism: str, hops: int = 1
                  ) -> Tuple[float, float, bool]:
        """(latency ns, energy uJ, occupies_channel) for one row copy."""
        m = get_mechanism(mechanism)
        return m.latency(self, hops), m.energy(self, hops), m.occupies_channel

    def mechanism_table(self) -> np.ndarray:
        """Dense ``(n_mechanisms, 5)`` float32 coefficient table, row ``i`` =
        ``(lat_base, lat_per_hop, e_base, e_per_hop, occupies_channel)`` for
        the mechanism with ``mech_id == i``; ``cost(h) = base + per_hop *
        max(h, 1)``.  The same lowering ``controller.mechanism_params``
        applies per config, as one dense array for mechanism-indexed
        sweeps."""
        rows = [m.coefficients(self) for m in mechanisms()]
        return np.asarray(rows, np.float32)

    def precharge_latency(self, linked: bool) -> float:
        """LISA-LIP: linked precharge 13 ns -> 5 ns (2.6x, Sec. 3.3)."""
        return self.lisa.t_pre_linked if linked else self.lisa.t_pre_baseline

    def table1(self) -> Dict[str, Tuple[float, float]]:
        """Table 1 rows: display name -> (latency ns, DRAM energy uJ)."""
        return {
            "memcpy": (self.copy_latency("memcpy"),
                       self.copy_energy("memcpy")),
            "RC-InterSA": (self.copy_latency("rc_intersa"),
                           self.copy_energy("rc_intersa")),
            "RC-Bank": (self.copy_latency("rc_bank"),
                        self.copy_energy("rc_bank")),
            "RC-IntraSA": (self.copy_latency("rc_intrasa"),
                           self.copy_energy("rc_intrasa")),
            "LISA-RISC-1": (self.copy_latency("lisa", 1),
                            self.copy_energy("lisa", 1)),
            "LISA-RISC-7": (self.copy_latency("lisa", 7),
                            self.copy_energy("lisa", 7)),
            "LISA-RISC-15": (self.copy_latency("lisa", 15),
                             self.copy_energy("lisa", 15)),
        }


# ---------------------------------------------------------------------------
# Copy-mechanism registry (replaces the string if/elif chains).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CopyMechanism:
    """One bulk row-copy mechanism, cost = ``base + per_hop * max(h, 1)``.

    ``hop_dependent`` mechanisms (LISA-RISC) require ``hops >= 1`` and scale
    with subarray distance; the others are flat and ignore ``hops`` beyond
    the clamp.  ``occupies_channel`` is the bank-level-parallelism property
    of Sec. 3.1: memcpy owns the off-chip channel for its whole duration,
    in-DRAM mechanisms leave it free (RC-Bank moves over the shared internal
    bus, also off-channel).
    """

    name: str
    mech_id: int
    occupies_channel: bool
    hop_dependent: bool
    lat_base: Callable[[DramSpec], float]
    lat_per_hop: Callable[[DramSpec], float]
    e_base: Callable[[DramSpec], float]
    e_per_hop: Callable[[DramSpec], float]
    description: str = ""

    def _check(self, hops: int) -> int:
        if self.hop_dependent and hops < 1:
            raise ValueError(
                f"{self.name} requires at least one hop (adjacent subarrays)")
        return max(int(hops), 1)

    def latency(self, spec: DramSpec, hops: int = 1) -> float:
        return self.lat_base(spec) + self.lat_per_hop(spec) * self._check(hops)

    def energy(self, spec: DramSpec, hops: int = 1) -> float:
        return self.e_base(spec) + self.e_per_hop(spec) * self._check(hops)

    def coefficients(self, spec: DramSpec) -> Tuple[float, float, float, float, float]:
        return (self.lat_base(spec), self.lat_per_hop(spec),
                self.e_base(spec), self.e_per_hop(spec),
                float(self.occupies_channel))


_MECHANISMS: Dict[str, CopyMechanism] = {}


def register_mechanism(mech: CopyMechanism) -> CopyMechanism:
    if mech.name in _MECHANISMS:
        raise ValueError(f"copy mechanism {mech.name!r} already registered")
    ids = {m.mech_id for m in _MECHANISMS.values()}
    if mech.mech_id in ids:
        raise ValueError(f"mech_id {mech.mech_id} already taken")
    _MECHANISMS[mech.name] = mech
    return mech


def get_mechanism(name: str) -> CopyMechanism:
    try:
        return _MECHANISMS[name]
    except KeyError:
        raise ValueError(f"unknown copy mechanism: {name!r} "
                         f"(known: {sorted(_MECHANISMS)})") from None


def mechanism_id(name: str) -> int:
    return get_mechanism(name).mech_id


def mechanisms() -> Tuple[CopyMechanism, ...]:
    """All registered mechanisms, ordered by ``mech_id`` (table row order)."""
    return tuple(sorted(_MECHANISMS.values(), key=lambda m: m.mech_id))


def mechanism_names() -> Tuple[str, ...]:
    return tuple(m.name for m in mechanisms())


# ---- closed-form cost components (Table 1 decompositions) ------------------

def _lat_memcpy(s: DramSpec) -> float:
    """memcpy over the channel: read phase + write phase.  The paper's Fig. 2
    shows memcpy ~= RC-InterSA; the command model gives 1393.75 ns (within
    2.2% of RC-InterSA); Table 1 leaves the cell blank."""
    t = s.timing
    read_phase = (t.tRCD + t.tCL + s.lines_per_row * t.tCCD + t.tBURST
                  + t.tRTP + t.tRP)
    write_phase = (t.tRCD + t.tCWL + s.lines_per_row * t.tCCD + t.tBURST
                   + t.tWR + t.tRP)
    return read_phase + write_phase


def _lat_rc_intersa(s: DramSpec) -> float:
    """RowClone PSM within a bank: 128 RD + 128 WR serialized over the
    internal bus, plus ACT(src)/ACT(dst)/PRE.  = 1363.75 ns."""
    t = s.timing
    return 2 * s.lines_per_row * t.tCCD + t.tRAS + t.tRAS + t.tRP


def _lat_rc_bank(s: DramSpec) -> float:
    """RowClone PSM across banks: ACT, first-read tCL, pipelined col ops,
    trailing burst, write recovery, PRE.  = 701.25 ns."""
    t = s.timing
    return (t.tRCD + t.tCL + s.lines_per_row * t.tCCD + t.tBURST + t.tWR
            + t.tRP)


def _lat_rc_intrasa(s: DramSpec) -> float:
    """RowClone FPM: ACT(src) tRAS -> ACT(dst) tRAS -> PRE.  = 83.75 ns."""
    t = s.timing
    return t.tRAS + t.tRAS + t.tRP


def _e_memcpy(s: DramSpec) -> float:
    # 128 lines read over the channel + 128 written back = 256 transfers.
    return _e_rc_intersa(s) + 2 * s.lines_per_row * s.energy.e_col_channel


def _e_rc_intersa(s: DramSpec) -> float:
    return (4 * s.energy.e_act_pre
            + 4 * s.lines_per_row * s.energy.e_col_internal
            + s.energy.e_intersa_extra)                       # 4.33


def _e_rc_bank(s: DramSpec) -> float:
    return (4 * s.energy.e_act_pre
            + 2 * s.lines_per_row * s.energy.e_col_internal)  # 2.08


def _zero(s: DramSpec) -> float:
    return 0.0


register_mechanism(CopyMechanism(
    name="memcpy", mech_id=0, occupies_channel=True, hop_dependent=False,
    lat_base=_lat_memcpy, lat_per_hop=_zero,
    e_base=_e_memcpy, e_per_hop=_zero,
    description="CPU copy over the off-chip channel (read + write phases)"))

register_mechanism(CopyMechanism(
    name="rc_intersa", mech_id=1, occupies_channel=False, hop_dependent=False,
    lat_base=_lat_rc_intersa, lat_per_hop=_zero,
    e_base=_e_rc_intersa, e_per_hop=_zero,
    description="RowClone PSM between subarrays over the internal bus"))

register_mechanism(CopyMechanism(
    name="rc_bank", mech_id=2, occupies_channel=False, hop_dependent=False,
    lat_base=_lat_rc_bank, lat_per_hop=_zero,
    e_base=_e_rc_bank, e_per_hop=_zero,
    description="RowClone PSM between banks (pipelined internal-bus copy)"))

register_mechanism(CopyMechanism(
    name="rc_intrasa", mech_id=3, occupies_channel=False, hop_dependent=False,
    lat_base=_lat_rc_intrasa, lat_per_hop=_zero,
    e_base=lambda s: 2 * s.energy.e_act_pre, e_per_hop=_zero,
    description="RowClone FPM within one subarray (back-to-back ACTs)"))

# LISA-RISC energy 0.09 + (h-1)*e_hop rewritten hop-linear:
# e_base' = e_risc_base - e_rbm_hop, so cost(h) = e_base' + e_hop * h.
register_mechanism(CopyMechanism(
    name="lisa", mech_id=4, occupies_channel=False, hop_dependent=True,
    lat_base=lambda s: s.lisa.risc_base(s.timing),
    lat_per_hop=lambda s: s.lisa.t_rbm_hop,
    e_base=lambda s: s.energy.e_risc_base - s.energy.e_rbm_hop,
    e_per_hop=lambda s: s.energy.e_rbm_hop,
    description="LISA-RISC: RBM hop chain between subarrays (Sec. 3.1)"))

# The fork subsystem's pricing anchor (repro/fork, PAPERS.md arXiv
# 1805.03502): an in-subarray page alias costs one RowClone FPM
# (ACT->ACT->PRE, 83.75 ns / 0.06 uJ at hops=1 — identical to rc_intrasa),
# and a cross-subarray materialization grows per hop like a LISA chain
# (same hop-linear rewrite as lisa: base' = base - per_hop, cost(h) =
# base' + per_hop * h).  NOT a Table-1 row: table1() is the paper's fixed
# set; this mechanism exists so plan() can price `fork` transfers.
register_mechanism(CopyMechanism(
    name="rowclone", mech_id=5, occupies_channel=False, hop_dependent=True,
    lat_base=lambda s: _lat_rc_intrasa(s) - s.lisa.t_rbm_hop,
    lat_per_hop=lambda s: s.lisa.t_rbm_hop,
    e_base=lambda s: 2 * s.energy.e_act_pre - s.energy.e_rbm_hop,
    e_per_hop=lambda s: s.energy.e_rbm_hop,
    description="RowClone page alias: FPM in-subarray, LISA-hop "
                "materialization across (fork/CoW pricing)"))


# ---------------------------------------------------------------------------
# Preset registry.
# ---------------------------------------------------------------------------

_PRESETS: Dict[str, DramSpec] = {}


def register_preset(spec: DramSpec, *, overwrite: bool = False) -> DramSpec:
    if not overwrite and spec.name in _PRESETS:
        raise ValueError(f"preset {spec.name!r} already registered")
    _PRESETS[spec.name] = spec
    return spec


def get_preset(name: str) -> DramSpec:
    try:
        return _PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown DRAM preset: {name!r} "
                         f"(known: {sorted(_PRESETS)})") from None


def preset_names() -> Tuple[str, ...]:
    return tuple(sorted(_PRESETS))


#: Calibrated default — reproduces the paper's Table 1 exactly.
DDR3_1600 = register_preset(DramSpec(name="DDR3_1600"))

#: DDR4-2400 (17-17-17): faster column cadence, same LISA/energy calibration
#: (the RBM path is a cell-array property, not an interface property).
DDR4_2400 = register_preset(DramSpec(
    name="DDR4_2400",
    timing=DramTiming(tCK=0.833, tRCD=14.16, tRP=14.16, tRAS=32.0,
                      tCL=14.16, tCWL=10.0, tCCD=3.33, tBURST=3.33,
                      tWR=15.0, tRTP=7.5, tREFI=7800.0, tRFC=350.0),
    channel_bw_gbps=19.2))

#: LPDDR4-3200 x32: slower core timings, narrower channel, deeper banks.
LPDDR4_3200 = register_preset(DramSpec(
    name="LPDDR4_3200",
    n_subarrays=32,
    timing=DramTiming(tCK=0.625, tRCD=18.0, tRP=21.0, tRAS=42.0,
                      tCL=18.0, tCWL=10.0, tCCD=5.0, tBURST=5.0,
                      tWR=18.0, tRTP=7.5, tREFI=3904.0, tRFC=180.0),
    channel_bw_gbps=12.8))
