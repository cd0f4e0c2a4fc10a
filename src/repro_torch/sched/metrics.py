# Port of src/repro/sched/metrics.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""Serving metrics: per-class latency percentiles, SLO attainment, slot
utilization, and cumulative :class:`~repro_torch.movement.plan.MovementCost`
(lisa vs memcpy) per scheduling decision.

Everything is recorded on the scheduler's *virtual clock* (modeled ns): a
decode tick costs ``decode_ns``, and every movement decision — resume wave,
preemption suspend, completion suspend — is charged its plan's Table-1
pricing, VILLA-occupancy-aware (a fast-tier hit pays the fast-subarray
fraction of the slow-tier cost).  The lisa/memcpy totals are the serving
layer's view of the paper's headline gap: the same schedule, priced under
both mechanisms.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np


def percentile_ns(xs, q) -> Optional[float]:
    """Percentile of a latency list; ``None`` for an empty one — a class
    with no completions has NO latency distribution.  (The old NaN leaked
    through ``round`` into summaries where an idle class read as a perfect
    p99, and ``json.dump(..., allow_nan=False)`` would crash on it; None
    serializes as strict-JSON ``null``.)

    ``method="linear"`` is pinned explicitly: it is numpy's current
    default, but the p50/p99 in committed BENCH artifacts must stay
    byte-stable even if a future numpy changes the default interpolation
    (single- and two-element buckets are the cases where methods disagree
    most — covered by tests)."""
    if not xs:
        return None
    return float(np.percentile(np.asarray(xs, np.float64), q,
                               method="linear"))


def _round(x: Optional[float], nd: int) -> Optional[float]:
    return None if x is None else round(x, nd)


@dataclasses.dataclass
class JobRecord:
    """One completed logical job (a fresh request or one follow-up)."""
    job_id: int
    uid: int
    kind: str               # "fresh" | "resume"
    priority: int
    arrival_ns: float
    done_ns: float
    slo_ns: float
    tokens: int
    migrations: int = 0     # cross-replica session moves while serving it

    @property
    def latency_ns(self) -> float:
        return self.done_ns - self.arrival_ns

    @property
    def slo_met(self) -> bool:
        return self.latency_ns <= self.slo_ns


@dataclasses.dataclass
class Decision:
    """One scheduling decision and its modeled movement bill (both
    mechanisms — per-decision Table-1 accounting)."""
    tick: int
    kind: str               # "submit" | "resume_wave" | "preempt_suspend"
                            # | "complete_suspend" | "migrate_wave"
    n_items: int
    ns_lisa: float = 0.0
    ns_memcpy: float = 0.0
    uj_lisa: float = 0.0
    uj_memcpy: float = 0.0
    # chaos-run kinds: "snapshot_wave" (write-behind: priced, not charged
    # to the clock), "recover_wave", "retry_wave" (both on the clock)
    backoff_ns: float = 0.0
    # retry backoff: mechanism-independent waiting charged to the clock
    # but NEVER to ns_lisa/ns_memcpy — folding it into both skewed the
    # reported advantage ratio with the fault rate (its own bucket keeps
    # the lisa-vs-memcpy A/B fault-rate-invariant)


class Metrics:
    """Accumulates job completions, decisions and per-tick occupancy;
    :meth:`summary` renders the benchmark/CI-facing dict."""

    def __init__(self):
        self.jobs: List[JobRecord] = []
        self.decisions: List[Decision] = []
        self._occupancy: List[float] = []
        self._replica_occ: List[List[float]] = []   # cluster runs only
        self._faults: Dict[str, int] = {}
        self._fault_class: Dict[int, Dict[str, int]] = {}
        # bank-model stalls (contention-on runs only): kind -> (ns, count)
        self._stalls: Dict[str, List[float]] = {}
        # the tracer's per-phase/per-leg rollup (repro_torch.obs); set by the
        # scheduler at the end of a traced run, None on untraced runs so
        # untraced summaries are byte-identical to pre-obs output
        self.trace: Optional[Dict[str, object]] = None

    # ---- recording --------------------------------------------------------
    def record_job(self, rec: JobRecord) -> None:
        self.jobs.append(rec)

    def record_decision(self, dec: Decision) -> None:
        self.decisions.append(dec)

    def record_fault(self, kind: str, priority: Optional[int] = None,
                     n: int = 1) -> None:
        """Count one chaos event (``injected`` / ``detected`` /
        ``recovered`` / ``lost`` / ``requeued`` / ``retries`` /
        ``replica_failures`` / ``degraded``), optionally attributed to the
        affected job's class."""
        self._faults[kind] = self._faults.get(kind, 0) + n
        if priority is not None:
            per = self._fault_class.setdefault(priority, {})
            per[kind] = per.get(kind, 0) + n

    def record_stall(self, kind: str, ns: float) -> None:
        """Count one bank-model stall (``refresh`` — a decode tick pushed
        out of a tRFC window; ``contention`` — wave members queued behind
        same-bank work).  Only contention-on runs record these, so
        contention-off summaries stay byte-identical to the pre-bank
        schema."""
        acc = self._stalls.setdefault(kind, [0.0, 0])
        acc[0] += ns
        acc[1] += 1

    def record_tick(self, n_active: int, n_slots: int,
                    per_replica: Optional[Sequence[float]] = None) -> None:
        self._occupancy.append(n_active / n_slots if n_slots else 0.0)
        if per_replica is not None:
            self._replica_occ.append(list(per_replica))

    # ---- summaries --------------------------------------------------------
    def movement_totals(self) -> Dict[str, float]:
        """Cumulative movement bill under both mechanisms, plus the
        ``backoff_ns`` latency bucket (clock time that moved no bytes —
        kept OUT of the per-mechanism ns so ``advantage`` is a pure
        movement ratio, invariant to the fault rate)."""
        t = {"ns_lisa": 0.0, "ns_memcpy": 0.0, "uj_lisa": 0.0,
             "uj_memcpy": 0.0, "backoff_ns": 0.0}
        for d in self.decisions:
            t["ns_lisa"] += d.ns_lisa
            t["ns_memcpy"] += d.ns_memcpy
            t["uj_lisa"] += d.uj_lisa
            t["uj_memcpy"] += d.uj_memcpy
            t["backoff_ns"] += d.backoff_ns
        t["advantage"] = (t["ns_memcpy"] / t["ns_lisa"]
                          if t["ns_lisa"] else 1.0)
        return t

    def decision_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in self.decisions:
            out[d.kind] = out.get(d.kind, 0) + 1
        return out

    def wave_widths(self, kind: str) -> List[int]:
        """Item counts of every decision of ``kind`` — a fused wave of k
        suspends/resumes is ONE decision with ``n_items == k``."""
        return [d.n_items for d in self.decisions if d.kind == kind]

    def _class_summary(self, jobs: List[JobRecord]) -> Dict[str, object]:
        """Latency/SLO summary of one job bucket.  An EMPTY bucket (or one
        with no SLO-bearing jobs) reports ``None``, never a number — an
        idle class must not read as a perfect p99/attainment."""
        lats = [j.latency_ns for j in jobs]
        with_slo = [j for j in jobs if math.isfinite(j.slo_ns)]
        return {
            "n": len(jobs),
            "p50_latency_ns": _round(percentile_ns(lats, 50), 1),
            "p99_latency_ns": _round(percentile_ns(lats, 99), 1),
            "slo_attainment": (round(sum(j.slo_met for j in with_slo)
                                     / len(with_slo), 4)
                               if with_slo else None),
        }

    def migration_summary(self) -> Dict[str, object]:
        """Cross-replica view: how many sessions moved, and the latency
        split between jobs whose service involved a migration and jobs
        served entirely at home (the cluster's Table-1 question: did the
        hop chain pay for itself?)."""
        moved = [j for j in self.jobs if j.migrations > 0]
        local = [j for j in self.jobs if j.migrations == 0]
        return {
            "sessions_migrated": sum(d.n_items for d in self.decisions
                                     if d.kind == "migrate_wave"),
            "migrate_waves": sum(1 for d in self.decisions
                                 if d.kind == "migrate_wave"),
            "jobs_migrated": len(moved),
            "p99_latency_ns_migrated": _round(
                percentile_ns([j.latency_ns for j in moved], 99), 1),
            "p99_latency_ns_local": _round(
                percentile_ns([j.latency_ns for j in local], 99), 1),
        }

    def fault_summary(self) -> Dict[str, object]:
        """The chaos block: fleet-wide event counters plus the per-class
        retry/recovery/loss attribution.  Buckets that saw nothing report
        ``None`` (strict-JSON ``null``), never a fake zero distribution —
        the ``per_class`` map is ``None`` on a fault-free run."""
        per_class = ({str(c): dict(sorted(d.items()))
                      for c, d in sorted(self._fault_class.items())}
                     if self._fault_class else None)
        return {"counters": dict(sorted(self._faults.items())),
                "per_class": per_class}

    def summary(self) -> Dict[str, object]:
        per_class: Dict[str, Dict[str, object]] = {}
        for cls in sorted({j.priority for j in self.jobs}):
            per_class[str(cls)] = self._class_summary(
                [j for j in self.jobs if j.priority == cls])
        overall = self._class_summary(self.jobs)
        out = {
            "jobs_completed": len(self.jobs),
            "tokens": sum(j.tokens for j in self.jobs),
            "p50_latency_ns": overall["p50_latency_ns"],
            "p99_latency_ns": overall["p99_latency_ns"],
            "slo_attainment": overall["slo_attainment"],
            "per_class": per_class,
            "slot_utilization": (round(sum(self._occupancy)
                                       / len(self._occupancy), 4)
                                 if self._occupancy else 0.0),
            "movement": {k: round(v, 2)
                         for k, v in self.movement_totals().items()},
            "decisions": self.decision_counts(),
            "faults": self.fault_summary(),
        }
        if self._stalls:                # bank-contention run: stall view
            out["stalls"] = {k: {"ns": round(v[0], 2), "n": int(v[1])}
                             for k, v in sorted(self._stalls.items())}
        if self._replica_occ:           # cluster run: per-replica view
            n_rep = len(self._replica_occ[0])
            out["per_replica_utilization"] = [
                round(sum(t[r] for t in self._replica_occ)
                      / len(self._replica_occ), 4) for r in range(n_rep)]
            out["migration"] = self.migration_summary()
        if self.trace is not None:      # traced run: span rollup
            out["trace"] = self.trace
        return out
