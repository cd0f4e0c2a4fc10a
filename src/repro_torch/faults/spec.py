# Port of src/repro/faults/spec.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""Deterministic fault model: what goes wrong, when, and under which seed.

Chang's thesis (PAPERS.md) spends whole chapters on DRAM latency/reliability
variation and the ECC-style machinery controllers carry to survive it; LISA's
RBM hop chains multiply the surfaces where a transfer can be corrupted.  This
module is the *model* half of the chaos subsystem: a frozen
:class:`FaultSpec` plus a :class:`FaultInjector` whose every draw comes from
a counter-based seeded RNG (``np.random.default_rng((seed, counter))``) —
never wall-clock, never global RNG state — so an entire chaos run replays
bit-identically from ``(spec, workload)`` and CI can gate on exact counters.

The injector is also the host-side *ledger* of the zero-silent-corruption
invariant: every fired fault must end in exactly one bucket —

    ``retry_fixed``   a movement retry re-copied the leg clean
    ``recovered``     a snapshot restore repaired the session pre-resume
    ``detected``      the checksum verify caught it at resume (served lost)
    ``corrupted``     still at rest, counted by the end-of-run scrub

``fired == retry_fixed + new_corrupt + merged`` and ``new_corrupt ==
recovered + detected + destroyed + len(corrupted)`` hold at every step
(``destroyed``: the corrupt copy died with its replica); the chaos bench
asserts both against the device-side verify counter.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

# fault-mode name -> traced int32 code.  "none" is the null fault; modes
# register themselves via repro_torch.faults.inject.register_fault (the fifth
# instance of the PR 1 registry pattern), which assigns the next code at
# import time so codes are deterministic per registration order.
FAULT_CODES: Dict[str, int] = {"none": 0}

# the uniform traced fault operand: (mode, index, xor) int32.  Passing this
# when no fault fires keeps jitted signatures identical -> zero recompiles.
NULL_FAULT = np.zeros(3, np.int32)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One chaos scenario, fully determined by its fields (all seeded).

    ``rate`` is the per-opportunity fault probability (movement waves and
    per-tick storage draws); ``replica_failures`` / ``degrade_fast`` are
    scheduled ``(tick, replica)`` events.  ``recover`` arms retries and
    snapshot-based repair; off, corruptions land and must still be detected.
    """
    rate: float = 0.0
    seed: int = 0
    kinds: Tuple[str, ...] = ("flip_byte",)
    recover: bool = True
    max_retries: int = 3
    backoff_base_ns: float = 500.0
    backoff_cap_ns: float = 8000.0
    replica_failures: Tuple[Tuple[int, int], ...] = ()
    degrade_fast: Tuple[Tuple[int, int], ...] = ()

    def __post_init__(self):
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"fault rate must be in [0, 1], got {self.rate}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        unknown = [k for k in self.kinds if k == "none"]
        if unknown or not self.kinds:
            raise ValueError(f"kinds must name registered fault modes, "
                             f"got {self.kinds}")


class FaultInjector:
    """Seeded, replayable fault source + corruption ledger.

    Draw ``i`` uses ``np.random.default_rng((seed, i))`` — a fresh
    SeedSequence per opportunity, so injection sites can be added or
    reordered without perturbing unrelated draws beyond the counter shift,
    and nothing ever touches wall-clock or global RNG state
    (repro-lint's ``wallclock-in-virtual-clock`` rule stays green).
    """

    def __init__(self, spec: FaultSpec):
        # validate mode names against the registry (import registers modes)
        from repro_torch.faults import inject as _inject  # noqa: F401
        for k in spec.kinds:
            if k not in FAULT_CODES:
                raise ValueError(f"unknown fault kind {k!r} "
                                 f"(known: {sorted(FAULT_CODES)})")
        self.spec = spec
        self._counter = 0
        self.corrupted: Dict[int, int] = {}      # uid -> fire counter
        self.counters: Dict[str, int] = {
            "fired": 0, "movement_fired": 0, "storage_fired": 0,
            "retries": 0, "retry_fixed": 0, "merged": 0,
            "new_corrupt": 0, "detected": 0, "recovered": 0,
            "destroyed": 0,
        }

    # -- draws ------------------------------------------------------------

    def _rng(self) -> np.random.Generator:
        rng = np.random.default_rng((self.spec.seed, self._counter))
        self._counter += 1
        return rng

    def draw_movement(self, n_bytes: int, n_pages: int) -> np.ndarray:
        """One fault opportunity on a movement wave of ``n_bytes`` payload
        laid out as ``n_pages`` pages; returns the traced (3,) int32 fault
        operand (NULL_FAULT when the draw does not fire)."""
        if self.spec.rate <= 0.0:
            return NULL_FAULT
        rng = self._rng()
        if rng.random() >= self.spec.rate:
            return NULL_FAULT
        kind = self.spec.kinds[int(rng.integers(len(self.spec.kinds)))]
        self.counters["fired"] += 1
        self.counters["movement_fired"] += 1
        if kind == "flip_byte":
            return np.array([FAULT_CODES[kind],
                             int(rng.integers(n_bytes)),
                             int(rng.integers(1, 256))], np.int32)
        return np.array([FAULT_CODES[kind],
                         int(rng.integers(n_pages)), 0], np.int32)

    def draw_storage(self, n_candidates: int, n_pages: int,
                     page_bytes: int) -> Optional[Tuple[int, int, int, int]]:
        """One per-tick at-rest corruption opportunity over ``n_candidates``
        suspended sessions; returns ``(candidate, page, byte, xor)`` or
        ``None``.  Only flips bytes (a zeroed page of an all-zero payload
        would be undetectable by ANY checksum — byte flips always land)."""
        if self.spec.rate <= 0.0 or n_candidates <= 0:
            return None
        rng = self._rng()
        if rng.random() >= self.spec.rate:
            return None
        self.counters["fired"] += 1
        self.counters["storage_fired"] += 1
        return (int(rng.integers(n_candidates)), int(rng.integers(n_pages)),
                int(rng.integers(page_bytes)), int(rng.integers(1, 256)))

    # -- ledger -----------------------------------------------------------

    def note_corrupt(self, uid: int) -> bool:
        """Record that ``uid``'s at-rest pages are now corrupt; returns
        True for a NEW incident (already-corrupt sessions merge)."""
        if uid in self.corrupted:
            self.counters["merged"] += 1
            return False
        self.corrupted[uid] = self.counters["fired"]
        self.counters["new_corrupt"] += 1
        return True

    def is_corrupt(self, uid: int) -> bool:
        return uid in self.corrupted

    def consume_corrupt(self, uid: int, outcome: str) -> None:
        """Close out a corrupt session: ``outcome`` is ``"detected"`` (served
        corrupt, caught by the resume-time verify) or ``"recovered"``
        (snapshot restore repaired it before service)."""
        if self.corrupted.pop(uid, None) is not None:
            self.counters[outcome] += 1

    def discard_corrupt(self, uid: int) -> None:
        """The corrupt copy itself was destroyed (replica failure) — the
        incident resolves with the session, not via the verify path."""
        if self.corrupted.pop(uid, None) is not None:
            self.counters["destroyed"] += 1

    # -- recovery pricing & scheduled events ------------------------------

    def backoff_ns(self, attempt: int) -> float:
        """Bounded exponential backoff for retry ``attempt`` (1-based)."""
        return float(min(self.spec.backoff_base_ns * (2 ** (attempt - 1)),
                         self.spec.backoff_cap_ns))

    def replica_failures_at(self, tick: int) -> List[int]:
        return [r for (t, r) in self.spec.replica_failures if t == tick]

    def degrade_at(self, tick: int) -> List[int]:
        return [r for (t, r) in self.spec.degrade_fast if t == tick]

    def summary(self) -> Dict[str, int]:
        out = dict(self.counters)
        out["at_rest_corrupt"] = len(self.corrupted)
        return out
