# Port of src/repro/sched/workload.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""Synthetic serving traffic: Poisson/bursty arrivals, Zipfian session
re-use, think-time distributions.

The controller benchmarks synthesize *memory* traffic because the paper's
SPEC traces are not redistributable (:mod:`repro_torch.core.dram.traces`); this
module is the serving-layer analogue for *request* traffic, reusing the same
generator idioms — a frozen config dataclass holding only workload knobs,
exponential inter-arrival gaps, and a Zipf draw via the inverse-CDF
(``searchsorted`` over the cumulative mass) rather than per-event
``choice``.  Generation is host-side numpy: arrivals feed the host-resident
scheduler loop, not a jitted sweep.

An :class:`Arrival` is either a *fresh* request (prompt attached) or a
*follow-up* — the chat pattern: a previously-served session returns after a
think time and must be resumed from the VILLA tiered store.  Follow-up
targets are Zipf-skewed toward the earliest sessions, which is exactly the
hot-session skew the paper's caching policy (and the ``cost_aware``
scheduling policy) exploit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np


class Arrival(NamedTuple):
    t_ns: float
    uid: int
    kind: str                   # "fresh" | "resume"
    priority: int               # class id, 0 = most urgent
    slo_ns: float               # inf = batch class, no deadline
    new_tokens: int
    prompt: Optional[np.ndarray]    # fresh only


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Workload knobs only — engine/scheduler geometry lives elsewhere."""
    n_fresh: int = 8                 # distinct sessions (uids 0..n_fresh-1)
    n_followups: int = 16            # resume events over those sessions
    mean_gap_ns: float = 2_000.0     # mean inter-arrival gap
    arrival: str = "poisson"         # "poisson" | "bursty"
    burst: int = 4                   # arrivals per burst (bursty mode)
    zipf_s: float = 1.2              # follow-up target skew (0 = uniform)
    think_ns: float = 4_000.0        # mean think time before a follow-up
    prompt_lens: Tuple[int, ...] = (6, 8, 10, 12)
    new_tokens: Tuple[int, ...] = (3, 4, 5, 6)
    # class id -> (admission probability, latency SLO); classes with an
    # infinite SLO are batch traffic that only aging protects.
    class_probs: Tuple[float, ...] = (0.25, 0.5, 0.25)
    class_slo_ns: Tuple[float, ...] = (30_000.0, 120_000.0, math.inf)

    def __post_init__(self):
        if len(self.class_probs) != len(self.class_slo_ns):
            raise ValueError("class_probs and class_slo_ns must align")
        if abs(sum(self.class_probs) - 1.0) > 1e-9:
            raise ValueError("class_probs must sum to 1")
        if self.arrival not in ("poisson", "bursty"):
            raise ValueError(f"unknown arrival process {self.arrival!r}")


def _zipf_pick(rng: np.random.Generator, n: int, s: float, k: int
               ) -> np.ndarray:
    """k Zipf(s) draws over ranks 0..n-1 via the inverse CDF (the
    ``traces.generate`` idiom: cumulative mass + searchsorted)."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-s)
    p /= p.sum()
    u = rng.random(k)
    return np.minimum(np.searchsorted(np.cumsum(p), u), n - 1).astype(int)


def generate_workload(cfg: WorkloadConfig, *, seed: int,
                      vocab_size: int) -> List[Arrival]:
    """One deterministic arrival stream, sorted by time.

    Fresh sessions arrive on the base process (exponential gaps; bursty mode
    groups ``burst`` arrivals at one instant with the gap scaled up to keep
    the offered load equal).  Each follow-up targets an already-arrived
    session (Zipf rank over fresh arrival order — session 0 is hottest) and
    lands one think time after the base instant.
    """
    rng = np.random.default_rng(seed)
    n = cfg.n_fresh + cfg.n_followups
    if cfg.n_fresh < 1:
        raise ValueError("need at least one fresh session")

    # base instants: one per event; bursty mode collapses each group of
    # `burst` onto its group head so bursts hit the queue at one instant
    gaps = rng.exponential(cfg.mean_gap_ns, n)
    if cfg.arrival == "bursty":
        gaps = gaps * cfg.burst
        gaps[np.arange(n) % cfg.burst != 0] = 0.0
    base_t = np.cumsum(gaps)

    # interleave kinds: event i is fresh while fresh remain, except that the
    # first event is always fresh (a follow-up needs a prior session); the
    # order is a deterministic shuffle of the remaining kind labels
    kinds = np.array(["fresh"] * cfg.n_fresh + ["resume"] * cfg.n_followups)
    rng.shuffle(kinds)
    first_fresh = int(np.argmax(kinds == "fresh"))
    kinds[0], kinds[first_fresh] = kinds[first_fresh], kinds[0]

    cls = rng.choice(len(cfg.class_probs), size=n, p=cfg.class_probs)
    plens = rng.choice(cfg.prompt_lens, size=n)
    ntoks = rng.choice(cfg.new_tokens, size=n)
    think = rng.exponential(cfg.think_ns, n)

    arrivals: List[Arrival] = []
    fresh_uids: List[int] = []
    followup_picks = iter(_zipf_pick(rng, max(cfg.n_fresh, 1), cfg.zipf_s,
                                     cfg.n_followups))
    for i in range(n):
        pr = int(cls[i])
        if kinds[i] == "fresh":
            uid = len(fresh_uids)
            fresh_uids.append(uid)
            prompt = rng.integers(0, vocab_size, int(plens[i])).astype(
                np.int32)
            arrivals.append(Arrival(t_ns=float(base_t[i]), uid=uid,
                                    kind="fresh", priority=pr,
                                    slo_ns=cfg.class_slo_ns[pr],
                                    new_tokens=int(ntoks[i]), prompt=prompt))
        else:
            # Zipf rank over the sessions that exist *so far*: rank r picks
            # the r-th earliest session (clamped into the current set).
            rank = min(int(next(followup_picks)), len(fresh_uids) - 1)
            arrivals.append(Arrival(t_ns=float(base_t[i] + think[i]),
                                    uid=fresh_uids[rank], kind="resume",
                                    priority=pr,
                                    slo_ns=cfg.class_slo_ns[pr],
                                    new_tokens=int(ntoks[i]), prompt=None))
    arrivals.sort(key=lambda a: (a.t_ns, a.uid))
    return arrivals


def n_sessions_for(cfg: WorkloadConfig) -> int:
    """Store sizing that makes uid collisions (explicit evictions)
    impossible for this workload: one store index per distinct session."""
    return max(cfg.n_fresh, 2)


def skewed_residence_burst(vocab_size: int, *, burst_slo_ns: float = 18_000.0,
                           seed: int = 7) -> List[Arrival]:
    """The transient-imbalance scenario the cluster migration A/B gates on
    (consumed by both ``benchmarks/run.py cluster`` and
    ``tests/test_cluster.py`` — one definition, two drivers).

    Three long equal-class jobs pin replicas 0..2 of a 4x1-slot cluster, so
    four interactive sessions serialize onto replica 3 and all SUSPEND
    there; then all four return at once under a tight SLO.  Migration-
    enabled placement fans the burst across the (by then idle) other
    replicas via priced hop-chain plans; migration-off serializes the whole
    burst on the home replica and misses.  Run with a large ``age_every``
    (e.g. 64) so aging doesn't let the setup jobs preempt the pinners.
    """
    rng = np.random.default_rng(seed)
    arr = [Arrival(t_ns=0.0, uid=100 + i, kind="fresh", priority=1,
                   slo_ns=math.inf, new_tokens=30,
                   prompt=rng.integers(0, vocab_size, 8).astype(np.int32))
           for i in range(3)]
    arr += [Arrival(t_ns=1500.0 + 500.0 * i, uid=i, kind="fresh",
                    priority=1, slo_ns=60_000.0, new_tokens=3,
                    prompt=rng.integers(0, vocab_size, 6).astype(np.int32))
            for i in range(4)]
    arr += [Arrival(t_ns=45_000.0, uid=i, kind="resume", priority=0,
                    slo_ns=burst_slo_ns, new_tokens=3, prompt=None)
            for i in range(4)]
    return arr
