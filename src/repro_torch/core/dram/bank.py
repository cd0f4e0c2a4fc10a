# Port of src/repro/core/dram/bank.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""Bank-level contention under the virtual clock: refresher, per-bank
state machines, and a request multiplexer.

This is the LASMIcon decomposition (misoc, SNIPPETS.md) ported onto
:class:`~repro_torch.core.dram.spec.DramSpec`'s Table-1 timings — the missing
piece ROADMAP calls "bank-level realism":

  * :class:`Refresher` — issues an all-bank refresh every ``tREFI`` and
    blocks the whole rank for ``tRFC``.  Refresh windows are a pure
    function of absolute (virtual) time, window ``k`` occupying
    ``[k*tREFI, k*tREFI + tRFC)`` for ``k >= 1`` — so idle fast-forwards
    cannot "skip" a pending refresh: any command issued inside a window is
    pushed to its end, no matter how the clock got there.
  * :class:`BankMachine` — one bank's row-state machine: row-open/closed
    tracking with ``tRCD`` activation, ``tRP`` precharge and the ``tRAS``
    restoration window an open row must honor before it may close.
  * :class:`RequestMultiplexer` — maps each priced request (a
    ``MovementPlan`` leg's service time, a decode tick) onto a bank at a
    ready time and grants it a ``(start, end)`` occupancy: requests on
    *distinct* banks overlap (subarray/bank-level parallelism), requests
    on the *same* bank serialize exactly, and every start is pushed out of
    refresh windows.

Everything here runs on the scheduler's deterministic virtual clock
(modeled ns): no wall-clock reads, no RNG — repro-lint's
``wallclock-in-virtual-clock`` rule covers this module for exactly that
reason.  Contention never changes *pricing*: a ``MovementCost`` stays the
isolated Table-1 bill; the multiplexer only decides *when* that bill's
service window lands (``movement.contend`` pairs the two).

See DESIGN.md Sec. 15 for the paper mapping and a worked two-route
migration-wave example.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.dram.spec import DramSpec, DramTiming


class Refresher:
    """All-bank refresh on a fixed cadence: window ``k`` (``k >= 1``)
    occupies ``[k*tREFI, k*tREFI + tRFC)`` on the virtual clock.

    Windows are derived from absolute time, never from mutable state — a
    scheduler that fast-forwards its clock across three windows still sees
    the fourth one block, and two schedulers that reach the same virtual
    time agree on every past and future window (determinism the BENCH
    gates rely on).
    """

    def __init__(self, tREFI: float, tRFC: float):
        if not 0.0 < tRFC < tREFI:
            raise ValueError(f"need 0 < tRFC ({tRFC}) < tREFI ({tREFI})")
        self.tREFI = float(tREFI)
        self.tRFC = float(tRFC)

    def window(self, k: int) -> Tuple[float, float]:
        """The ``k``-th refresh window ``[start, end)`` (``k >= 1``)."""
        if k < 1:
            raise ValueError(f"refresh windows are 1-indexed, got {k}")
        return k * self.tREFI, k * self.tREFI + self.tRFC

    def window_at(self, t_ns: float) -> Optional[int]:
        """Index of the refresh window covering ``t_ns``, else None."""
        k = int(math.floor(t_ns / self.tREFI))
        if k >= 1 and t_ns < k * self.tREFI + self.tRFC:
            return k
        return None

    def next_free(self, t_ns: float) -> float:
        """Earliest time ``>= t_ns`` outside every refresh window — where
        a command landing at ``t_ns`` may actually issue."""
        k = self.window_at(t_ns)
        return t_ns if k is None else k * self.tREFI + self.tRFC

    def refreshes_before(self, t_ns: float) -> int:
        """How many refresh windows have *started* by ``t_ns`` — the
        count a fast-forwarded clock must still account for."""
        return max(0, int(math.floor(t_ns / self.tREFI)))

    def stall_ns(self, t_ns: float) -> float:
        return self.next_free(t_ns) - t_ns


@dataclasses.dataclass
class BankMachine:
    """One bank's state machine: the open row, when it was activated, and
    when the bank's current occupancy window ends.

    ``accept`` grants a request its service window: wait for the bank to
    free (``busy_until``), pay the row transition (``tRP`` precharge after
    the ``tRAS`` restoration window, ``tRCD`` activate) when the request
    names a row the bank does not have open, and never start inside a
    refresh window.  Deliberately *open-page*: the row stays open after
    service, so back-to-back requests to the same row are row hits.
    """

    timing: DramTiming
    refresher: Refresher
    busy_until: float = 0.0
    open_row: Optional[int] = None
    act_at: float = -math.inf       # when the open row was activated
    n_requests: int = 0
    n_row_hits: int = 0
    n_row_misses: int = 0
    queue_stall_ns: float = 0.0     # waited behind same-bank work
    refresh_stall_ns: float = 0.0   # pushed out of a refresh window

    def accept(self, t_ready: float, service_ns: float,
               row: Optional[int] = None) -> Tuple[float, float]:
        """Grant one request: returns its ``(start, end)`` occupancy."""
        if service_ns < 0:
            raise ValueError(f"negative service time {service_ns}")
        t = max(t_ready, self.busy_until)
        overhead = 0.0
        if row is not None:
            if self.open_row == row:
                self.n_row_hits += 1
            else:
                self.n_row_misses += 1
                if self.open_row is not None:
                    # the open row must sit tRAS past its ACT before the
                    # precharge that closes it may issue
                    t = max(t, self.act_at + self.timing.tRAS)
                    overhead += self.timing.tRP
                overhead += self.timing.tRCD
        # an all-bank refresh blocks the start; a request already in
        # service runs to completion (the JEDEC pull-in/postpone slack)
        start = self.refresher.next_free(t)
        self.queue_stall_ns += t - t_ready
        self.refresh_stall_ns += start - t
        if row is not None and self.open_row != row:
            self.act_at = start + overhead - self.timing.tRCD
            self.open_row = row
        end = start + overhead + service_ns
        self.busy_until = end
        self.n_requests += 1
        return start, end


class RequestMultiplexer:
    """The arbiter between priced requests and bank/refresh resources.

    One multiplexer serves one scheduler: every movement-wave member and
    every decode tick submits ``(bank, ready, service_ns)`` and receives
    the ``(start, end)`` window the model grants.  With ``enabled=False``
    the multiplexer is a pure pass-through — ``(ready, ready+service)``,
    today's isolated pricing, bit-identical — so contention is an A/B arm,
    not a fork of the scheduler.

    Stall accounting (all in modeled ns, summed across requests):
      * ``queue_stall_ns``   — time spent behind an earlier request or a
        row transition on the same bank;
      * ``refresh_stall_ns`` — time pushed out of refresh windows.
    """

    def __init__(self, spec: Union[DramSpec, DramTiming], *,
                 n_banks: int = 8, enabled: bool = True):
        timing = spec.timing if isinstance(spec, DramSpec) else spec
        if n_banks < 1:
            raise ValueError(f"n_banks must be >= 1, got {n_banks}")
        self.timing = timing
        self.n_banks = int(n_banks)
        self.enabled = bool(enabled)
        self.refresher = Refresher(timing.tREFI, timing.tRFC)
        self.banks: List[BankMachine] = [
            BankMachine(timing, self.refresher) for _ in range(self.n_banks)]
        self.stats: Dict[str, float] = {
            "n_requests": 0, "queue_stall_ns": 0.0,
            "refresh_stall_ns": 0.0, "decode_refresh_stall_ns": 0.0,
            "n_decode_stalls": 0}

    # ---- routing -----------------------------------------------------------
    def bank_of(self, uid: int) -> int:
        """Deterministic session-to-bank map: a session's pages live in one
        bank for its whole life (uid mod n_banks)."""
        return int(uid) % self.n_banks

    # ---- the multiplexer ---------------------------------------------------
    def submit(self, bank: int, t_ready: float, service_ns: float,
               row: Optional[int] = None) -> Tuple[float, float]:
        """Grant one request its ``(start, end)`` service window.

        Disabled: ``(t_ready, t_ready + service_ns)`` — the isolated cost,
        untouched.  Enabled: the bank machine serializes same-bank
        requests, charges row transitions, and the refresher pushes starts
        out of refresh windows; disjoint banks overlap freely.
        """
        if not self.enabled:
            return t_ready, t_ready + service_ns
        if not 0 <= bank < self.n_banks:
            raise ValueError(f"bank {bank} out of range [0, {self.n_banks})")
        b = self.banks[bank]
        q0, r0 = b.queue_stall_ns, b.refresh_stall_ns
        start, end = b.accept(t_ready, service_ns, row)
        self.stats["n_requests"] += 1
        self.stats["queue_stall_ns"] += b.queue_stall_ns - q0
        self.stats["refresh_stall_ns"] += b.refresh_stall_ns - r0
        return start, end

    def wave(self, items: Sequence[Tuple[int, float]],
             t_ready: float) -> float:
        """Submit one fused wave — ``(bank, service_ns)`` per member, all
        ready at ``t_ready`` — and return its completion time.  Members on
        distinct banks overlap; same-bank members serialize in submission
        order (deterministic: callers submit in wave order)."""
        end = t_ready
        for bank, service_ns in items:
            _, e = self.submit(bank, t_ready, service_ns)
            end = max(end, e)
        return end

    def decode_gate(self, t_ns: float) -> float:
        """Earliest time ``>= t_ns`` a decode tick may issue: an all-bank
        refresh blocks every bank, so a tick landing inside ``tRFC`` waits
        for the window to close.  Returns the (possibly pushed) start."""
        if not self.enabled:
            return t_ns
        start = self.refresher.next_free(t_ns)
        if start > t_ns:
            self.stats["decode_refresh_stall_ns"] += start - t_ns
            self.stats["n_decode_stalls"] += 1
        return start

    # ---- introspection -----------------------------------------------------
    def refreshes_before(self, t_ns: float) -> int:
        return self.refresher.refreshes_before(t_ns)

    def snapshot(self) -> Dict[str, float]:
        """Stall counters plus per-bank activity, JSON-ready (the bench
        artifact's contention block)."""
        out = {k: (round(v, 3) if isinstance(v, float) else v)
               for k, v in self.stats.items()}
        out["n_banks"] = self.n_banks
        out["enabled"] = self.enabled
        out["per_bank_requests"] = [b.n_requests for b in self.banks]
        out["row_hits"] = sum(b.n_row_hits for b in self.banks)
        out["row_misses"] = sum(b.n_row_misses for b in self.banks)
        return out
