# Port of src/repro/sched/queue.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""Admission queue: priority classes, per-request deadlines, aging.

Every request that cannot be placed immediately waits here — admission never
crashes the engine (`EngineFull` is a *scheduler* bug, not a traffic
condition).  An entry carries the request's priority class (0 = most
urgent), its arrival time and latency SLO (``deadline_ns = arrival + slo``),
and the tick it was enqueued at.

Starvation freedom is structural: the *effective* class of a waiting entry
drops by one every ``age_every`` ticks, **unbounded below zero**, so any
entry — however low its nominal class — eventually outranks every fresh
arrival.  Policies (:mod:`repro_torch.sched.policy`) order candidates by effective
class first; the bound "aging promotes the oldest queued request within
``priority * age_every`` extra ticks past any class-0 arrival" is pinned by
``tests/test_sched.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class QueueEntry:
    """One unit of queued work: a fresh request (``prompt`` set) or the
    resumption of a suspended session (``kind == "resume"``, prompt None).
    ``new_tokens`` is the number of tokens still owed to the job."""
    seq: int                    # global admission order (FIFO tie-break)
    job_id: int                 # scheduler job this entry belongs to
    uid: int
    kind: str                   # "fresh" | "resume"
    priority: int               # nominal class, 0 = most urgent
    arrival_ns: float
    slo_ns: float               # math.inf = no deadline (batch class)
    enq_tick: int               # tick the entry entered the queue
    new_tokens: int
    prompt: Optional[np.ndarray] = None

    @property
    def deadline_ns(self) -> float:
        return self.arrival_ns + self.slo_ns


class AdmissionQueue:
    """FIFO-ordered storage with aging; selection order is policy-owned.

    The queue itself never drops or reorders — it hands policies a snapshot
    of entries plus each entry's *effective* class at the current tick, and
    removes exactly the entries the scheduler placed.
    """

    def __init__(self, age_every: int = 8):
        if age_every < 1:
            raise ValueError(f"age_every must be >= 1 (got {age_every})")
        self.age_every = age_every
        self._items: List[QueueEntry] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._items)

    def push(self, *, job_id: int, uid: int, kind: str, priority: int,
             arrival_ns: float, slo_ns: float, tick: int, new_tokens: int,
             prompt: Optional[np.ndarray] = None,
             seq: Optional[int] = None) -> QueueEntry:
        """Enqueue one unit of work.  ``seq`` may be supplied to *re*-queue
        preempted work under its original admission order (fairness: a
        preemption must not send a job to the back of the line)."""
        if kind not in ("fresh", "resume"):
            raise ValueError(f"unknown queue entry kind {kind!r}")
        if kind == "fresh" and prompt is None:
            raise ValueError("a fresh entry needs its prompt")
        if new_tokens < 1:
            raise ValueError(f"queued work owes >= 1 token (got {new_tokens})")
        if seq is None:
            seq = self._seq
            self._seq += 1
        e = QueueEntry(seq=seq, job_id=job_id, uid=uid, kind=kind,
                       priority=priority, arrival_ns=arrival_ns,
                       slo_ns=slo_ns, enq_tick=tick, new_tokens=new_tokens,
                       prompt=prompt)
        self._items.append(e)
        return e

    def effective_class(self, e: QueueEntry, tick: int) -> int:
        """Nominal class minus one per ``age_every`` waited ticks, unbounded
        below zero — the starvation-freedom mechanism."""
        return e.priority - (tick - e.enq_tick) // self.age_every

    def entries(self) -> Tuple[QueueEntry, ...]:
        return tuple(self._items)

    def remove(self, entry: QueueEntry) -> None:
        self._items.remove(entry)

    def oldest_wait(self, tick: int) -> int:
        """Ticks the longest-waiting entry has been queued (0 if empty)."""
        return max((tick - e.enq_tick for e in self._items), default=0)

    def max_priority(self) -> int:
        return max((e.priority for e in self._items), default=0)

    def bounded_wait_ticks(self, priority: int) -> int:
        """Upper bound on how long a class-``priority`` entry can wait past
        the point a class-0 entry would be served: aging closes one class
        per ``age_every`` ticks and then strictly outranks class 0."""
        return (priority + 1) * self.age_every
