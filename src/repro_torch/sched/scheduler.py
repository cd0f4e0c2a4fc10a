# Port of src/repro/sched/scheduler.py: SchedConfig, Job, Wave, Scheduler,
# ClusterWave and ClusterScheduler.  The clock, lane_log, decisions and
# metrics are host arithmetic in the reference's operations and order.
"""The tick loop: a cost-aware continuous-batching scheduler that owns the
serving :class:`~repro_torch.serve.engine.Engine`.

Every bulk transfer of the engine is a priced
:class:`~repro_torch.movement.plan.MovementPlan`; this module is the controller
that finally *consumes* those prices.  The paper mapping (DESIGN.md Sec. 9):

  * **tick ↔ controller cycle** — each :meth:`Scheduler.tick` is one memory-
    controller scheduling cycle: service the in-flight work, pick the next
    commands from the queue;
  * **fused waves ↔ inter-subarray hops** — admissions batch into one
    ``suspend_many`` / ``resume_many`` dispatch per wave, the way LISA moves
    a whole row per hop instead of a cache line per channel transfer; the
    scheduler never issues per-session suspend/resume dispatches;
  * **plan-prep / decode overlap ↔ LISA-LIP linked precharge** — the fused
    decode dispatch is issued first (``Engine.step_begin``), the next wave
    is planned on the host *while the device decodes*, and only then is the
    decode synced (``step_end``) — scheduling work hides behind data
    movement exactly as LIP hides the precharge behind the RBM hop;
  * **cost-aware placement ↔ Table 1** — the ``cost_aware`` policy scores
    every suspend/resume candidate by its plan's modeled ns/uJ under the
    active :class:`~repro_torch.core.dram.spec.DramSpec` mechanism and the VILLA
    fast-tier occupancy (a resident session reads at the fast-subarray
    timings; suspending it pays the write-through to both pools).

Time is a *virtual clock* in modeled nanoseconds: a decode tick costs
``decode_ns``, prefills cost ``prefill_ns_per_token`` per prompt token, and
every movement wave is charged its occupancy-aware plan cost under the
active mechanism — so a policy that schedules cheaper movement finishes the
same offered load earlier, deterministically: the clock and every
decision are host arithmetic, identical on the CPU and the card.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

from repro_torch import movement as MV
from repro_torch.core.dram.bank import RequestMultiplexer
from repro_torch.faults.recover import (repair_row, restore_session,
                                        snapshot_sessions)
from repro_torch.faults.spec import FaultInjector
from repro_torch.obs import NULL_TRACER
from repro_torch.sched.metrics import Decision, JobRecord, Metrics
from repro_torch.sched.policy import (AdmitCand, PlaceCand, SchedContext,
                                      SchedPolicy, VictimCand, get_policy)
from repro_torch.sched.queue import AdmissionQueue, QueueEntry
from repro_torch.sched.workload import Arrival
from repro_torch.serve.engine import Engine, Request


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    decode_ns: float = 1_000.0        # modeled cost of one fused decode step
    prefill_ns_per_token: float = 250.0
    age_every: int = 8                # ticks per one-class aging promotion
    mechanism: str = "lisa"           # clock + scoring mechanism
    preempt: bool = True              # allow class-based slot preemption
    max_wave: int = 0                 # cap on placements per tick (0 = none)
    # bank-level contention (DESIGN.md Sec. 15): when on, every movement
    # and decode tick routes through a RequestMultiplexer — same-bank work
    # serializes, refresh windows (tREFI/tRFC) stall, disjoint banks
    # overlap.  Off (default) keeps the isolated-cost clock bit-identical.
    contention: bool = False
    n_banks: int = 8

    def __post_init__(self):
        if self.mechanism not in ("lisa", "memcpy"):
            raise ValueError(f"unknown mechanism {self.mechanism!r} "
                             "(clock pricing needs 'lisa' or 'memcpy')")
        if self.n_banks < 1:
            raise ValueError(f"n_banks must be >= 1, got {self.n_banks}")


@dataclasses.dataclass
class Job:
    """One logical unit of traffic (a fresh request or one follow-up) across
    its whole life: queued -> active (possibly preempted and re-queued) ->
    done.  ``done`` counts tokens emitted so far; the engine-level
    ``Request`` is re-created per activation, the Job is not."""
    job_id: int
    uid: int
    kind: str                  # "fresh" | "resume"
    priority: int
    arrival_ns: float
    slo_ns: float
    target_new: int
    done: int = 0
    state: str = "queued"      # queued | active | done
    slot: int = -1
    seed_tokens: int = 0       # generated[0] is a resume seed, not new work
    done_ns: float = math.nan
    migrations: int = 0        # cross-replica moves while serving this job


class Wave(NamedTuple):
    """One tick's prepared placement decisions (computed while the decode
    dispatch is in flight, executed after the sync)."""
    victims: Tuple[int, ...]            # slots to preempt (one fused suspend)
    placements: Tuple[AdmitCand, ...]   # queue entries to place


class Scheduler:
    """Owns the engine: all submits, suspends and resumes route through
    :meth:`tick`.  Callers feed traffic either up-front (``arrivals=``) or
    incrementally (:meth:`offer`) and drive :meth:`run`."""

    def __init__(self, engine: Engine, policy="cost_aware",
                 arrivals: Sequence[Arrival] = (),
                 cfg: SchedConfig = SchedConfig(), *, tracer=None):
        self.eng = engine
        self.policy: SchedPolicy = get_policy(policy)
        self.cfg = cfg
        self.queue = AdmissionQueue(age_every=cfg.age_every)
        self.metrics = Metrics()
        self.tick_count = 0
        self.now_ns = 0.0
        # span tracing (repro_torch.obs): host bookkeeping on the virtual clock.
        # NULL_TRACER makes every trace call a no-op, so untraced runs pay
        # nothing and traced runs change no scheduling decision or charge.
        self.trace = tracer if tracer is not None else NULL_TRACER
        if self.trace.enabled:
            for lane in range(self._trace_lanes()):
                self.trace.seek(lane, 0.0)       # pre-seed lane cursors
            if hasattr(engine, "attach_tracer"):
                engine.attach_tracer(self.trace)
        self._arrivals: List[Arrival] = sorted(arrivals,
                                               key=lambda a: (a.t_ns, a.uid))
        self._arrival_keys: List[Tuple[float, int]] = [
            (a.t_ns, a.uid) for a in self._arrivals]
        self._next_arrival = 0
        self._jobs: Dict[int, Job] = {}
        self._slot_job: Dict[int, Job] = {}      # slot -> active job
        self._last_active: Dict[int, int] = {}   # uid -> activation tick
        # fast-subarray latency fraction (paper Sec. 3.2: TL-DRAM-like near
        # segment): a fast-tier hit pays this fraction of the slow-tier move
        t, v = engine.spec.timing, engine.villa_cfg
        self.fast_ratio = ((v.tRCD_fast + v.tRAS_fast + v.tRP_fast)
                           / (t.tRCD + t.tRAS + t.tRP))
        # bank-level contention (cfg.contention): the multiplexer the whole
        # tick loop shares.  Disabled it is a pure pass-through, so the
        # contention-off clock is bit-identical to the pre-bank model.
        self.mux = RequestMultiplexer(engine.spec, n_banks=cfg.n_banks,
                                      enabled=cfg.contention)

    # ---- traffic ----------------------------------------------------------
    def offer(self, arrival: Arrival) -> None:
        """Feed one arrival incrementally.  Equivalent to having passed it
        in ``arrivals=`` up front: a burst offered as singletons schedules
        identically to the same burst offered as one list."""
        if arrival.t_ns < self.now_ns:
            arrival = arrival._replace(t_ns=self.now_ns)
        key = (arrival.t_ns, arrival.uid)
        pos = bisect.bisect(self._arrival_keys, key, lo=self._next_arrival)
        self._arrivals.insert(pos, arrival)
        self._arrival_keys.insert(pos, key)

    def submit_request(self, req: Request) -> None:
        """Admit one hand-built engine :class:`Request`: its scheduling
        metadata (``arrival_ns``, ``priority``, ``slo_ns``) IS the admission
        record — the metadata round-trips back out on the requests the
        scheduler constructs at placement time."""
        self.offer(Arrival(t_ns=req.arrival_ns, uid=req.uid, kind="fresh",
                           priority=req.priority, slo_ns=req.slo_ns,
                           new_tokens=req.max_new, prompt=req.prompt))

    def _admit_arrivals(self) -> None:
        while (self._next_arrival < len(self._arrivals)
               and self._arrivals[self._next_arrival].t_ns <= self.now_ns):
            a = self._arrivals[self._next_arrival]
            self._next_arrival += 1
            job = Job(job_id=len(self._jobs), uid=a.uid, kind=a.kind,
                      priority=a.priority, arrival_ns=a.t_ns, slo_ns=a.slo_ns,
                      target_new=a.new_tokens)
            self._jobs[job.job_id] = job
            self.queue.push(job_id=job.job_id, uid=a.uid, kind=a.kind,
                            priority=a.priority, arrival_ns=a.t_ns,
                            slo_ns=a.slo_ns, tick=self.tick_count,
                            new_tokens=a.new_tokens, prompt=a.prompt)

    def pending(self) -> bool:
        return bool(self._next_arrival < len(self._arrivals)
                    or len(self.queue) or self.eng.active)

    def _has_admissible(self) -> bool:
        """Whether any queued entry could be placed right now: fresh always,
        a follow-up only once its session has a suspended snapshot (with an
        idle engine no session can be active, so resumable == placeable)."""
        resumable = self.eng.session_pos
        return any(e.kind == "fresh" or e.uid in resumable
                   for e in self.queue.entries())

    # ---- cost model -------------------------------------------------------
    def _move_cost(self, direction: str, resident: bool
                   ) -> Tuple[float, float, float, float]:
        """(ns_lisa, ns_memcpy, uj_lisa, uj_memcpy) of one session move,
        VILLA-occupancy-aware: a resident resume reads the fast subarray
        (``fast_ratio`` of the slow cost); a resident suspend pays the
        write-through to both pools."""
        plan = (self.eng.plan_resume if direction == "resume"
                else self.eng.plan_suspend)
        c = plan.cost
        if direction == "resume":
            f = self.fast_ratio if resident else 1.0
        else:
            f = 1.0 + (self.fast_ratio if resident else 0.0)
        return c.ns_lisa * f, c.ns_memcpy * f, c.uj_lisa * f, c.uj_memcpy * f

    def _move_ns(self, direction: str, resident: bool) -> float:
        ns_l, ns_m, _, _ = self._move_cost(direction, resident)
        return ns_l if self.cfg.mechanism == "lisa" else ns_m

    def _place_ns(self, e: QueueEntry, fast_uids: frozenset) -> float:
        if e.kind == "resume":
            return self._move_ns("resume", e.uid in fast_uids)
        return self.cfg.prefill_ns_per_token * len(e.prompt)

    def _charge_wave(self, kind: str, moves: Sequence[bool],
                     direction: str,
                     lanes: Optional[Sequence[int]] = None) -> float:
        """Record one fused wave of session moves as ONE decision (both
        mechanisms) and return the active-mechanism ns for the clock.
        ``lanes`` optionally names the trace lane of each move (cluster
        waves land on per-replica lanes); default: the scheduler lane."""
        if not moves:
            return 0.0
        tot = [0.0, 0.0, 0.0, 0.0]
        costs = []
        for resident in moves:
            mc = self._move_cost(direction, resident)
            costs.append(mc)
            for i, v in enumerate(mc):
                tot[i] += v
        self.metrics.record_decision(Decision(
            tick=self.tick_count, kind=kind, n_items=len(moves),
            ns_lisa=tot[0], ns_memcpy=tot[1], uj_lisa=tot[2],
            uj_memcpy=tot[3]))
        if self.trace.enabled:
            self._trace_moves(kind, direction, moves, costs, lanes,
                              len(self.metrics.decisions) - 1)
        return tot[0] if self.cfg.mechanism == "lisa" else tot[1]

    def _wave_advance(self, kind: str, moves: Sequence[bool],
                      direction: str, *, uids: Sequence[int], t0: float,
                      lanes: Optional[Sequence[int]] = None) -> float:
        """Charge one fused wave to the ledger (isolated Table-1 pricing,
        via :meth:`_charge_wave`) and return the CLOCK advance: the
        isolated active-mechanism total when the bank model is off —
        bit-identical to the serial pre-bank clock — else the contended
        wave span through the multiplexer: every member ready at ``t0``,
        distinct banks overlapping, same-bank members serializing, starts
        pushed out of refresh windows.  Pricing never changes; only WHEN
        the wave completes does."""
        iso = self._charge_wave(kind, moves, direction, lanes=lanes)
        if not self.mux.enabled or not moves:
            return iso
        end = t0
        for uid, resident in zip(uids, moves):
            svc = self._move_ns(direction, resident)
            start, e = self.mux.submit(self.mux.bank_of(uid), t0, svc)
            if start > t0:
                self.metrics.record_stall("contention", start - t0)
            end = max(end, e)
        return end - t0

    def _lane_add(self, lanes: List[float], r: int, uid: int,
                  service_ns: float, t0: float) -> None:
        """Accumulate one movement on replica ``r``'s lane (serial within
        the lane).  Bank model off: plain ``+=`` — the pre-bank clock.
        On: the movement queues through the session's bank at its lane's
        current ready time, so same-bank work *across* lanes serializes
        and refresh windows push starts; the lane absorbs the full sojourn
        (stall + service)."""
        if not self.mux.enabled:
            lanes[r] += service_ns
            return
        ready = t0 + lanes[r]
        start, end = self.mux.submit(self.mux.bank_of(uid), ready,
                                     service_ns)
        if start > ready:
            self.metrics.record_stall("contention", start - ready)
        lanes[r] = end - t0

    def _trace_lanes(self) -> int:
        """Lane count: scheduler lane only, or (cluster) one per replica
        plus the write-behind lane."""
        n = getattr(self.eng, "n_replicas", 0)
        return n + 2 if n else 1

    def _trace_moves(self, kind: str, direction: str,
                     moves: Sequence[bool],
                     costs: Sequence[Tuple[float, float, float, float]],
                     lanes: Optional[Sequence[int]],
                     dec_index: int) -> None:
        """One trace span per charged move, with a child span per plan leg.

        The move attrs carry the SAME occupancy-scaled cost tuple the
        Decision ledger accumulated (``costs`` — not recomputed); leg attrs
        partition it exactly (``Tracer.move_span`` residual-corrects the
        last leg), and ``dec_index`` names the owning Decision, so per-leg
        sums grouped by decision reproduce ``Metrics.movement_totals()``
        bit-for-bit."""
        plan = (self.eng.plan_resume if direction == "resume"
                else self.eng.plan_suspend)
        legs = MV.leg_costs(plan, self.eng.spec)
        for i, (resident, mc) in enumerate(zip(moves, costs)):
            if direction == "resume":
                f = self.fast_ratio if resident else 1.0
            else:
                f = 1.0 + (self.fast_ratio if resident else 0.0)
            items = [(leg.kind,
                      (lc.ns_lisa * f, lc.ns_memcpy * f,
                       lc.uj_lisa * f, lc.uj_memcpy * f),
                      {"bytes": lc.bytes, "hops": lc.hops})
                     for leg, lc in zip(plan.legs, legs)]
            self.trace.move_span(
                kind, lanes[i] if lanes else 0, mc, items,
                attrs={"direction": direction, "decision": dec_index,
                       "fast_resident": bool(resident)})

    # ---- the tick ---------------------------------------------------------
    def tick(self) -> None:
        """One controller cycle: dispatch the fused decode, prepare the next
        wave while it is in flight, sync, then execute the wave (fused
        preemption suspends, one fused resume wave, prefill submits)."""
        self.tick_count += 1
        if (not self.eng.active and not self._has_admissible()
                and self._next_arrival < len(self._arrivals)):
            # idle (nothing decoding, nothing placeable — queued follow-ups
            # whose session hasn't been created yet don't count): fast-forward
            # the virtual clock to the next arrival
            self.now_ns = max(self.now_ns,
                              self._arrivals[self._next_arrival].t_ns)
        self._admit_arrivals()
        self.metrics.record_tick(len(self.eng.active), self.eng.slots)
        tr = self.trace
        tr.seek_all(self.now_ns)
        tick_sp = tr.begin_span("tick", lane=0, cat="tick",
                                attrs={"tick": self.tick_count,
                                       "queued": len(self.queue)})

        # 1. the tick's ONE fused decode dispatch (async — device decodes
        #    while the host plans; the LIP-linked-precharge analogue).  An
        #    all-bank refresh (tREFI/tRFC) blocks the dispatch: a tick
        #    landing inside the window waits for it to close, and idle
        #    fast-forwards cannot skip one — windows are a pure function of
        #    absolute virtual time
        handle = self.eng.step_begin()
        decoded = handle is not None
        stall = 0.0
        if decoded:
            if self.mux.enabled:
                stall = self.mux.decode_gate(self.now_ns) - self.now_ns
                if stall > 0.0:
                    self.metrics.record_stall("refresh", stall)
                    tr.emit("refresh_stall", stall, lane=0, cat="stall",
                            attrs={"refreshes": self.mux.refreshes_before(
                                self.now_ns + stall)})
            tr.emit("decode", self.cfg.decode_ns, lane=0, cat="decode",
                    attrs={"n_active": len(self.eng.active)})

        # 2. overlapped wave preparation against pre-step state
        fast_uids = self.eng.fast_resident_uids()
        wave = self._prepare_wave(fast_uids)
        tr.instant("plan", lane=0, cat="plan",
                   attrs={"victims": len(wave.victims),
                          "placements": len(wave.placements)})

        # 3. sync; the engine auto-suspends completed bursts as ONE wave
        completed = self.eng.step_end(handle)

        advance = (self.cfg.decode_ns + stall) if decoded else 0.0
        if completed:
            advance += self._wave_advance(
                "complete_suspend",
                [self._slot_job[s].uid in fast_uids for s, _ in completed],
                "suspend",
                uids=[self._slot_job[s].uid for s, _ in completed],
                t0=self.now_ns + advance)
        self.now_ns += advance
        for slot, req in completed:
            job = self._slot_job.pop(slot)
            job.done += len(req.generated) - job.seed_tokens
            self._complete_job(job, self.now_ns)

        # 4. execute the prepared wave
        self.now_ns += self._execute_wave(wave, fast_uids)
        tr.end_span(tick_sp, t1_ns=max(self.now_ns, tr.now(0)))

    def run(self, max_ticks: int = 200_000) -> Dict[str, object]:
        while self.pending():
            self._check_progress()
            self.tick()
            if self.tick_count > max_ticks:
                raise RuntimeError(
                    f"scheduler failed to drain within {max_ticks} ticks "
                    f"(queue={len(self.queue)}, active={len(self.eng.active)})")
        if self.trace.enabled:
            self.metrics.trace = self.trace.rollup()
        return self.metrics.summary()

    def _check_progress(self) -> None:
        """A queue that can never drain (every entry is a follow-up to a
        session evicted by a store-index collision) must fail loudly, not
        spin to ``max_ticks``.  Size ``n_sessions`` from the workload
        (:func:`repro_torch.sched.workload.n_sessions_for`) to rule this
        out."""
        if self.eng.active or self._next_arrival < len(self._arrivals):
            return
        if not self.queue:
            return
        resumable = set(self.eng.session_pos)
        dead = [e.uid for e in self.queue.entries()
                if e.kind == "resume" and e.uid not in resumable]
        if len(dead) == len(self.queue):
            raise RuntimeError(
                f"scheduler stuck: queued follow-ups target sessions with no "
                f"suspended snapshot (evicted uids: {sorted(set(dead))}); "
                f"size the engine's n_sessions to the workload's session "
                f"count")

    # ---- wave preparation (runs while the decode is in flight) ------------
    def _victim_cands(self, fast_uids: frozenset) -> List[VictimCand]:
        out = []
        shared = self.eng.shared_uids()     # host dicts only — no sync
        for slot, job in self._slot_job.items():
            resident = job.uid in fast_uids
            out.append(VictimCand(
                slot=slot, uid=job.uid, priority=job.priority,
                last_active_tick=self._last_active.get(job.uid, 0),
                suspend_ns=self._move_ns("suspend", resident),
                fast_resident=resident,
                shared=job.uid in shared))
        return out

    def _prepare_wave(self, fast_uids: frozenset) -> Wave:
        tick = self.tick_count
        ctx = SchedContext(tick=tick, now_ns=self.now_ns,
                           mechanism=self.cfg.mechanism, fast_uids=fast_uids)
        active_uids = {j.uid for j in self._slot_job.values()}
        resumable = set(self.eng.session_pos)
        cands = []
        for e in self.queue.entries():
            if e.kind == "resume" and (e.uid in active_uids
                                       or e.uid not in resumable):
                continue        # target still running / not yet suspended
            cands.append(AdmitCand(
                entry=e, eff_class=self.queue.effective_class(e, tick),
                cost_ns=self._place_ns(e, fast_uids),
                fast_resident=e.uid in fast_uids))

        free = len(self.eng.free_slots())
        budget = self.cfg.max_wave or len(cands)
        victims: List[VictimCand] = []
        placements: List[AdmitCand] = []
        picked_uids: set = set()
        victim_order: Optional[List[VictimCand]] = None
        for c in self.policy.admit_order(cands, ctx):
            if len(placements) >= budget:
                break
            if c.entry.uid in picked_uids:
                continue        # one placement per session per wave
            if free > 0:
                free -= 1
            elif self.cfg.preempt:
                # preempt only a strictly-worse class than the candidate's
                # aged class; victims ranked by the policy (cost_aware:
                # cheapest modeled suspend among the worst class)
                if victim_order is None:
                    victim_order = self.policy.victim_order(
                        self._victim_cands(fast_uids), ctx)
                v = next((v for v in victim_order
                          if v not in victims and v.priority > c.eff_class),
                         None)
                if v is None:
                    break       # admit_order is best-first: nothing later wins
                victims.append(v)
            else:
                break
            placements.append(c)
            picked_uids.add(c.entry.uid)
        return Wave(victims=tuple(v.slot for v in victims),
                    placements=tuple(placements))

    # ---- wave execution ---------------------------------------------------
    def _execute_wave(self, wave: Wave, fast_uids: frozenset) -> float:
        advance = 0.0
        # a completion during the overlapped decode may have evicted a
        # colliding store index — drop resumes whose snapshot vanished
        # (the progress check surfaces them if they can never be served)
        resumes = [c for c in wave.placements
                   if c.entry.kind == "resume"
                   and c.entry.uid in self.eng.session_pos]
        submits = [c for c in wave.placements if c.entry.kind == "fresh"]

        # preemption suspends: ONE fused dispatch for the whole wave.  A
        # planned victim may have completed during the overlapped decode —
        # its slot is already free, so it drops out; and every slot a
        # completion freed is credited against the wave first, so no job is
        # displaced for a placement that already has room (victims are in
        # policy order — the kept prefix is the best-victim prefix).
        victims = [s for s in wave.victims if s in self.eng.active]
        short = (len(resumes) + len(submits)) - len(self.eng.free_slots())
        victims = victims[:max(0, short)]
        if victims:
            requeue = []
            for slot in victims:
                job = self._slot_job.pop(slot)
                req = self.eng.active[slot]
                job.done += len(req.generated) - job.seed_tokens
                job.state, job.slot = "queued", -1
                self._last_active[job.uid] = self.tick_count
                requeue.append(job)
            if len(victims) == 1:
                self.eng.suspend(victims[0])
            else:
                self.eng.suspend_many(victims)
            advance += self._wave_advance(
                "preempt_suspend",
                [j.uid in fast_uids for j in requeue], "suspend",
                uids=[j.uid for j in requeue],
                t0=self.now_ns + advance)
            for job in requeue:
                # re-queue under the ORIGINAL admission order (seq == job_id
                # order is preserved by pushing with the job's first seq)
                self.queue.push(job_id=job.job_id, uid=job.uid, kind="resume",
                                priority=job.priority,
                                arrival_ns=job.arrival_ns, slo_ns=job.slo_ns,
                                tick=self.tick_count,
                                new_tokens=job.target_new - job.done,
                                seq=job.job_id)

        # session resumes: ONE fused resume_many wave, per-uid extra_new
        # (re-check snapshots: a preemption suspend just above can itself
        # evict a colliding store index)
        resumes = [c for c in resumes
                   if c.entry.uid in self.eng.session_pos]
        ready, extras = [], []
        for c in resumes:
            # the context envelope: decoding k tokens from position pos
            # writes cache positions pos..pos+k-1, so only `room` more
            # tokens fit; a follow-up past max_len completes with what the
            # session already produced ("context exhausted"), and a partial
            # fit serves the truncated budget
            room = self.eng.max_len - self.eng.session_pos[c.entry.uid]
            n = min(c.entry.new_tokens, room)
            job = self._jobs[c.entry.job_id]
            if n < 1:
                self.queue.remove(c.entry)
                job.target_new = job.done        # nothing more can be served
                self._complete_job(job, self.now_ns + advance)
                continue
            job.target_new -= c.entry.new_tokens - n
            ready.append(c)
            extras.append(n + 1)                 # +1: the restored seed token
        if ready:
            slots = self.eng.resume_many([c.entry.uid for c in ready], extras)
            for c, slot in zip(ready, slots):
                self._activate(c.entry, slot, seed_tokens=1)
            advance += self._wave_advance(
                "resume_wave", [c.fast_resident for c in ready], "resume",
                uids=[c.entry.uid for c in ready],
                t0=self.now_ns + advance)

        # fresh admissions: prefill inserts (inherently per-request — the
        # prefill is compute, not a session move)
        for c in submits:
            e = c.entry
            # fresh jobs fit the envelope too: prompt length n + k decoded
            # tokens occupy positions 0..n+k-2, so at most max_len-n+1 fit
            job = self._jobs[e.job_id]
            budget = min(e.new_tokens, self.eng.max_len - len(e.prompt) + 1)
            job.target_new -= e.new_tokens - budget
            req = Request(uid=e.uid, prompt=e.prompt, max_new=budget,
                          arrival_ns=e.arrival_ns, priority=e.priority,
                          slo_ns=e.slo_ns)
            slot = self.eng.submit(req)
            advance += self.cfg.prefill_ns_per_token * len(e.prompt)
            self.trace.emit(
                "prefill", self.cfg.prefill_ns_per_token * len(e.prompt),
                lane=0, cat="prefill",
                attrs={"uid": e.uid, "prompt_tokens": len(e.prompt)})
            self.metrics.record_decision(Decision(
                tick=self.tick_count, kind="submit", n_items=1))
            if slot in self.eng.active:
                self._activate(e, slot, seed_tokens=0)
            else:
                # a 1-token job: the prefill token met the budget and the
                # engine already suspended the session — complete it here
                self.queue.remove(e)
                job.done += len(req.generated)
                advance += self._wave_advance(
                    "complete_suspend", [job.uid in fast_uids], "suspend",
                    uids=[job.uid], t0=self.now_ns + advance)
                self._complete_job(job, self.now_ns + advance)
        return advance

    def _complete_job(self, job: Job, done_ns: float) -> None:
        """The single completion transition: every path that finishes a job
        (decode completion, one-token prefill, exhausted context) lands
        here."""
        job.state, job.slot, job.done_ns = "done", -1, done_ns
        self._last_active[job.uid] = self.tick_count
        self.metrics.record_job(JobRecord(
            job_id=job.job_id, uid=job.uid, kind=job.kind,
            priority=job.priority, arrival_ns=job.arrival_ns,
            done_ns=job.done_ns, slo_ns=job.slo_ns, tokens=job.done,
            migrations=job.migrations))

    def _activate(self, entry: QueueEntry, slot: int, *,
                  seed_tokens: int) -> None:
        self.queue.remove(entry)
        job = self._jobs[entry.job_id]
        job.state, job.slot, job.seed_tokens = "active", slot, seed_tokens
        self._slot_job[slot] = job
        self._last_active[job.uid] = self.tick_count

    # ---- introspection ----------------------------------------------------
    def jobs(self) -> Tuple[Job, ...]:
        return tuple(self._jobs.values())

    def active_jobs(self) -> Dict[int, Job]:
        return dict(self._slot_job)


class ClusterWave(NamedTuple):
    """One tick's prepared cluster decisions: preemption victims (global
    slots) and placements, each annotated with its target replica."""
    victims: Tuple[int, ...]
    placements: Tuple[AdmitCand, ...]
    targets: Tuple[int, ...]


class ClusterScheduler(Scheduler):
    """The cluster tick loop: admission, eviction AND placement.

    Drives a :class:`~repro_torch.serve.cluster.Cluster` through the same
    engine-shaped surface the base scheduler uses, plus the third decision
    axis: every placement picks a *replica*, scored by the policy's
    ``place_order`` over (free slots, VILLA fast-tier occupancy, modeled
    hop cost from the session's current residence).  A resume placed off
    its home replica triggers a live migration — suspended pages cross the
    mesh as one fused hop-chain plan per route — before the per-replica
    fused resume waves fire.  ``migrate=False`` pins every resume to its
    residence replica (the migration-off A/B arm).

    The virtual clock models the replicas as parallel lanes: each tick
    advances by one ``decode_ns`` (all replicas decode concurrently) plus
    the MAX over replicas of that replica's movement/prefill work, with a
    migration occupying both endpoints of its route.  The base scheduler's
    serial-advance semantics are unchanged.
    """

    def __init__(self, cluster, policy="cost_aware_cluster",
                 arrivals: Sequence[Arrival] = (),
                 cfg: SchedConfig = SchedConfig(), *, migrate: bool = True,
                 faults: Optional[FaultInjector] = None,
                 snapshot_every: int = 0, tracer=None):
        super().__init__(cluster, policy=policy, arrivals=arrivals, cfg=cfg,
                         tracer=tracer)
        self.cluster = cluster
        # trace lanes: 0 = scheduler, 1+r = replica r, last = write-behind
        self._wb_lane = cluster.n_replicas + 1
        self.migrate = migrate
        if snapshot_every < 0:
            raise ValueError(f"snapshot_every must be >= 0, "
                             f"got {snapshot_every}")
        # chaos wiring: the injector drives at-rest corruption and scheduled
        # replica/degrade events here; the cluster consumes the SAME
        # injector for movement-wave faults — one seeded draw stream
        self.faults = faults if faults is not None else cluster.faults
        self.snapshot_every = snapshot_every
        self._snaps: Dict[int, object] = {}     # uid -> SessionSnapshot
        self._lost_uids: Set[int] = set()       # sessions gone for good
        # per-tick lane accounting, for introspection and the lane-advance
        # regression test: each entry records the decode part, the lanes
        # seeded by complete-suspends, the final per-replica lanes after
        # wave execution, and the tick's total clock advance — the model's
        # contract is advance == decode_ns + max(lanes), never a sum of
        # per-phase maxima
        self.lane_log: List[Dict[str, object]] = []

    # ---- the tick (parallel replica lanes) --------------------------------
    def tick(self) -> None:
        self.tick_count += 1
        if (not self.eng.active and not self._has_admissible()
                and self._next_arrival < len(self._arrivals)):
            self.now_ns = max(self.now_ns,
                              self._arrivals[self._next_arrival].t_ns)
        self._admit_arrivals()
        self._fault_tick()
        self.metrics.record_tick(
            len(self.eng.active), self.eng.slots,
            per_replica=[len(e.active) / e.slots
                         for e in self.cluster.replicas])
        tr = self.trace
        tr.seek_all(self.now_ns)
        tick_sp = tr.begin_span("tick", lane=0, cat="tick",
                                attrs={"tick": self.tick_count,
                                       "queued": len(self.queue)})

        # 1. ONE fused decode dispatch per replica, all in flight at once.
        #    An all-bank refresh blocks the whole fleet's dispatch: windows
        #    are a pure function of absolute virtual time, so the idle
        #    fast-forward above cannot skip a pending one
        handle = self.eng.step_begin()
        decoded = handle is not None
        stall = 0.0
        if decoded:
            if self.mux.enabled:
                stall = self.mux.decode_gate(self.now_ns) - self.now_ns
                if stall > 0.0:
                    self.metrics.record_stall("refresh", stall)
                    tr.emit("refresh_stall", stall, lane=0, cat="stall",
                            attrs={"refreshes": self.mux.refreshes_before(
                                self.now_ns + stall)})
            tr.emit("decode", self.cfg.decode_ns, lane=0, cat="decode",
                    attrs={"n_active": len(self.eng.active)})
            if tr.enabled:
                # replica movement lanes start after the concurrent decode
                for r in range(self.cluster.n_replicas):
                    tr.seek(1 + r, tr.now(0))

        # 2. overlapped wave preparation against pre-step state
        fast_uids = self.eng.fast_resident_uids()
        wave = self._prepare_wave(fast_uids)
        tr.instant("plan", lane=0, cat="plan",
                   attrs={"victims": len(wave.victims),
                          "placements": len(wave.placements)})

        # 3. sync; completed bursts auto-suspend per replica (fused waves).
        #    ONE per-replica lanes vector carries ALL of the tick's
        #    post-decode movement — the complete-suspends seeded here AND
        #    the prepared wave executed below — so the tick advances by
        #    decode + max over replicas of each replica's TOTAL.  (The old
        #    accounting summed max(complete lanes) + max(wave lanes): two
        #    phase maxima added serially even though the model says a
        #    replica's wave work overlaps another replica's suspends.)
        completed = self.eng.step_end(handle)
        tick_t0 = self.now_ns
        advance = (self.cfg.decode_ns + stall) if decoded else 0.0
        lanes = [0.0] * self.cluster.n_replicas
        t0 = self.now_ns + advance
        if completed:
            flags = [self._slot_job[s].uid in fast_uids
                     for s, _ in completed]
            self._charge_wave("complete_suspend", flags, "suspend",
                              lanes=[self.cluster.replica_of(s) + 1
                                     for s, _ in completed])
            for (s, _), f in zip(completed, flags):
                self._lane_add(lanes, self.cluster.replica_of(s),
                               self._slot_job[s].uid,
                               self._move_ns("suspend", f), t0)
        seed = tuple(lanes)
        self.now_ns = t0
        for slot, req in completed:
            r = self.cluster.replica_of(slot)
            job = self._slot_job.pop(slot)
            job.done += len(req.generated) - job.seed_tokens
            self._complete_job(job, self.now_ns + lanes[r])

        # 4. execute the prepared wave on the SAME lanes
        self.now_ns += self._execute_wave(wave, fast_uids, lanes)
        self.lane_log.append({
            "tick": self.tick_count, "decode_ns": advance,
            "complete_lanes": seed, "lanes": tuple(lanes),
            "advance": self.now_ns - tick_t0})
        tr.end_span(tick_sp, t1_ns=max(self.now_ns, tr.now(0)))

    # ---- chaos: injection, snapshots, replica recovery --------------------
    def _mech_ns(self, c: MV.MovementCost) -> float:
        return c.ns_lisa if self.cfg.mechanism == "lisa" else c.ns_memcpy

    def _class_of(self, uid: int) -> Optional[int]:
        """Job class attribution for a chaos event on ``uid`` (latest job
        wins; chaos events are rare, the scan is fine)."""
        for j in reversed(list(self._jobs.values())):
            if j.uid == uid:
                return j.priority
        return None

    def _admit_arrivals(self) -> None:
        super()._admit_arrivals()
        if self._lost_uids:
            self._drain_lost()

    def _drain_lost(self) -> None:
        """Complete (as lost) queued follow-ups whose session died with a
        replica and has no snapshot: they can never be served, and leaving
        them queued would spin the run to ``max_ticks``.  A uid whose
        session has been re-created (fresh re-prefill in flight or done)
        is servable again and is skipped."""
        active_uids = {j.uid for j in self._slot_job.values()}
        fresh_uids = {e.uid for e in self.queue.entries()
                      if e.kind == "fresh"}
        resumable = set(self.eng.session_pos)
        for e in list(self.queue.entries()):
            if (e.kind != "resume" or e.uid not in self._lost_uids
                    or e.uid in resumable or e.uid in active_uids
                    or e.uid in fresh_uids):
                continue
            self.queue.remove(e)
            job = self._jobs[e.job_id]
            job.target_new = job.done
            self._complete_job(job, self.now_ns)
            self.metrics.record_fault("lost", job.priority)

    def _fault_tick(self) -> None:
        """The chaos gate at the top of every tick: refresh snapshots,
        fire scheduled replica failures / fast-tier degradations, and take
        this tick's seeded at-rest corruption draw."""
        inj, cl = self.faults, self.cluster
        if self.snapshot_every and self.tick_count % self.snapshot_every == 0:
            snaps, cost = snapshot_sessions(cl)
            if inj is not None:
                # never refresh a ledger-known corrupt session's snapshot:
                # the LAST CLEAN copy is the one recovery must restore
                snaps = {u: s for u, s in snaps.items()
                         if not inj.is_corrupt(u)}
            if snaps:
                self._snaps.update(snaps)
                # write-behind: snapshot bytes are priced and recorded but
                # NOT charged to the clock — the copy overlaps decode the
                # way LISA-VILLA's dirty-line writeback overlaps service
                self.metrics.record_decision(Decision(
                    tick=self.tick_count, kind="snapshot_wave",
                    n_items=len(snaps), ns_lisa=cost.ns_lisa,
                    ns_memcpy=cost.ns_memcpy, uj_lisa=cost.uj_lisa,
                    uj_memcpy=cost.uj_memcpy))
                if self.trace.enabled:
                    cs = (cost.ns_lisa, cost.ns_memcpy,
                          cost.uj_lisa, cost.uj_memcpy)
                    self.trace.move_span(
                        "snapshot_wave", self._wb_lane, cs,
                        [("snapshot", cs, {"bytes": cost.bytes})],
                        attrs={"n": len(snaps), "clock_charged": False,
                               "decision":
                                   len(self.metrics.decisions) - 1})
        if inj is None:
            return
        for r in inj.replica_failures_at(self.tick_count):
            self.trace.instant("replica_failure", lane=r + 1, cat="fault",
                               attrs={"replica": r})
            self._handle_replica_failure(r)
        for r in inj.degrade_at(self.tick_count):
            cl.degrade_fast(r)
            self.metrics.record_fault("degraded")
            self.trace.instant("fast_degraded", lane=r + 1, cat="fault",
                               attrs={"replica": r})
        # at-rest corruption: one seeded draw per tick over the suspended,
        # not-yet-corrupt sessions (deterministic candidate order).  An
        # ACTIVE session's store row is a stale copy the next suspend
        # overwrites wholesale — corrupting it would silently heal, so only
        # truly at-rest snapshots are candidates.
        active_uids = {req.uid for req in self.eng.active.values()}
        # fork-aware exclusion: the corruption target is the PHYSICAL row,
        # so a row with a marked alias is already corrupt for its whole
        # family — drawing a sibling would be a second incident on the
        # same bytes that one repair closes, splitting the ledger
        cands = [u for u in sorted(self.eng.session_pos)
                 if u not in active_uids
                 and not any(inj.is_corrupt(f) for f in self._family(u))]
        if cands:
            spec = cl.page_spec
            draw = inj.draw_storage(len(cands), spec.n_pages,
                                    spec.page_bytes)
            if draw is not None:
                ci, page, byte, xor = draw
                uid = cands[ci]
                eng = cl.replicas[cl.residence[uid]]
                # the PHYSICAL row (fork-aware): corrupting a shared row
                # rots every alias's bytes at once — and the scrub detects
                # it ONCE, per row, not per alias
                eng.corrupt_stored(eng.forks.resolve(uid), page, byte, xor)
                inj.note_corrupt(uid)
                self.metrics.record_fault("injected", self._class_of(uid))
                self.trace.instant(
                    "fault_injected", lane=cl.residence[uid] + 1,
                    cat="fault", attrs={"uid": uid, "page": int(page),
                                        "byte": int(byte)})

    def _family(self, uid: int) -> Tuple[int, ...]:
        """Every uid aliasing ``uid``'s physical store row on its home
        replica (``(uid,)`` for an exclusive row) — the unit chaos
        accounting works in, since corruption and repair both act on the
        row, not the alias."""
        eng = self.cluster.replicas[self.cluster.residence[uid]]
        if uid not in eng.forks:
            return (uid,)
        return eng.forks.aliases(eng.forks.resolve(uid))

    def _recovery_target(self, dead: int) -> Optional[int]:
        """Where refugees from a dead replica land: the surviving replica
        with the most free slots (lowest index on ties)."""
        if self.cluster.n_replicas < 2:
            return None
        free = self.cluster.free_by_replica()
        best = max((f, -r) for r, f in enumerate(free) if r != dead)
        return -best[1]

    def _handle_replica_failure(self, r: int) -> None:
        """Replica ``r`` dies mid-service.  Suspended sessions with a live
        snapshot are restored onto a surviving replica over the priced
        channel (charged to the clock as a ``recover_wave``); in-flight
        jobs are re-queued under their ORIGINAL admission seq — from their
        snapshot where one exists, from a fresh re-prefill of the prompt
        otherwise; sessions with neither are completed as lost so the
        queue stays drainable (starvation-free: requeues keep their aged
        class)."""
        cl, inj = self.cluster, self.faults
        # capture the jobs running on the dying replica BEFORE the wipe
        doomed = {g: self._slot_job.pop(g) for g in list(self._slot_job)
                  if cl.replica_of(g) == r}
        inflight, suspended = cl.fail_replica(r)
        self.metrics.record_fault("replica_failures")
        target = self._recovery_target(r)
        tot = [0.0, 0.0, 0.0, 0.0]
        recover_ns, n_restored = 0.0, 0

        def restore(uid: int) -> bool:
            nonlocal recover_ns, n_restored
            snap = self._snaps.get(uid)
            if snap is None or target is None:
                return False
            c = restore_session(cl, snap, target)
            if c is None:       # alias snap whose owner was not restored
                return False
            n_restored += 1
            recover_ns += self._mech_ns(c)
            for i, v in enumerate((c.ns_lisa, c.ns_memcpy,
                                   c.uj_lisa, c.uj_memcpy)):
                tot[i] += v
            if self.trace.enabled:
                cs = (c.ns_lisa, c.ns_memcpy, c.uj_lisa, c.uj_memcpy)
                # the recover_wave Decision is recorded AFTER the restores
                # (its index is the CURRENT ledger length); nothing in
                # between records a decision
                self.trace.move_span(
                    "recover_wave", target + 1, cs,
                    [("restore", cs, {"bytes": c.bytes, "uid": uid})],
                    attrs={"direction": "restore",
                           "decision": len(self.metrics.decisions)})
            return True

        # owners before aliases: an aliased snapshot restores by
        # re-attaching to its owner's already-restored physical row (one
        # repair heals the whole fork family), so the owner must land first
        def _owner_first(uid: int) -> tuple:
            snap = self._snaps.get(uid)
            alias = snap is not None and getattr(snap, "alias_of",
                                                 None) is not None
            return (alias, uid)

        for uid in sorted(suspended, key=_owner_first):
            if restore(uid):
                self.metrics.record_fault("recovered", self._class_of(uid))
            else:
                self._lost_uids.add(uid)
        for g, req in inflight:
            job = doomed.pop(g, None)
            if job is None:
                continue
            job.state, job.slot = "queued", -1
            self._last_active[job.uid] = self.tick_count
            if job.uid not in cl.session_pos:
                restore(job.uid)
            if job.uid in cl.session_pos:
                # tokens decoded since the snapshot died with the replica;
                # the job resumes from the snapshot state it restored to
                self.queue.push(job_id=job.job_id, uid=job.uid,
                                kind="resume", priority=job.priority,
                                arrival_ns=job.arrival_ns,
                                slo_ns=job.slo_ns, tick=self.tick_count,
                                new_tokens=job.target_new - job.done,
                                seq=job.job_id)
                self.metrics.record_fault("recovered", job.priority)
            elif job.kind == "fresh" and len(req.prompt):
                # no snapshot, but the prompt survives in the request:
                # re-prefill from scratch under the original admission seq
                job.done = 0
                self.queue.push(job_id=job.job_id, uid=job.uid,
                                kind="fresh", priority=job.priority,
                                arrival_ns=job.arrival_ns,
                                slo_ns=job.slo_ns, tick=self.tick_count,
                                new_tokens=job.target_new,
                                prompt=req.prompt, seq=job.job_id)
                self._lost_uids.discard(job.uid)
                self.metrics.record_fault("requeued", job.priority)
            else:
                self._lost_uids.add(job.uid)
                job.target_new = job.done
                self._complete_job(job, self.now_ns)
                self.metrics.record_fault("lost", job.priority)
        if inj is not None:
            for uid in list(self._lost_uids):
                if inj.is_corrupt(uid):
                    inj.discard_corrupt(uid)
        if n_restored:
            self.metrics.record_decision(Decision(
                tick=self.tick_count, kind="recover_wave",
                n_items=n_restored, ns_lisa=tot[0], ns_memcpy=tot[1],
                uj_lisa=tot[2], uj_memcpy=tot[3]))
            self.now_ns += recover_ns
        self._drain_lost()

    # ---- placement scoring ------------------------------------------------
    def _place_cands(self, e: QueueEntry, fast_uids: frozenset,
                     free: List[int], occ: List[float]) -> List[PlaceCand]:
        """Every replica this entry may land on, with its modeled bill.
        With migration off, a resume can ONLY land where its snapshot
        resides."""
        home = (self.cluster.residence.get(e.uid)
                if e.kind == "resume" else None)
        if e.kind == "resume" and not self.migrate:
            reps: Sequence[int] = (home,)
        else:
            reps = range(self.cluster.n_replicas)
        mech = self.cfg.mechanism
        # replicas already holding this session's fork family (the shared
        # physical row): placing there keeps the session an alias — a
        # zero-copy resume — instead of a cross-replica materialization
        family = {rr for rr, eng in enumerate(self.cluster.replicas)
                  if e.uid in eng.shared_uids()}
        out = []
        for r in reps:
            if e.kind == "resume":
                place = self._move_ns("resume",
                                      e.uid in fast_uids and r == home)
                hop = self.cluster.hop_ns(home, r, mech)
            else:
                place = self.cfg.prefill_ns_per_token * len(e.prompt)
                hop = 0.0
            out.append(PlaceCand(replica=r, free_slots=free[r],
                                 fast_occupancy=occ[r], hop_ns=hop,
                                 place_ns=place,
                                 degraded=self.cluster.replicas[
                                     r].fast_degraded,
                                 shared_resident=r in family))
        return out

    # ---- wave preparation (runs while the decodes are in flight) ----------
    def _prepare_wave(self, fast_uids: frozenset) -> ClusterWave:
        tick = self.tick_count
        ctx = SchedContext(tick=tick, now_ns=self.now_ns,
                           mechanism=self.cfg.mechanism, fast_uids=fast_uids)
        active_uids = {j.uid for j in self._slot_job.values()}
        resumable = set(self.eng.session_pos)
        free = self.cluster.free_by_replica()
        occ = self.cluster.fast_occupancy()
        cands = []
        # hop/place pricing per entry is computed ONCE; only the free-slot
        # counts change as the wave reserves slots below
        place_cache: Dict[int, List[PlaceCand]] = {}
        for e in self.queue.entries():
            if e.kind == "resume" and (e.uid in active_uids
                                       or e.uid not in resumable):
                continue
            pcs = self._place_cands(e, fast_uids, free, occ)
            place_cache[id(e)] = pcs
            cands.append(AdmitCand(
                entry=e, eff_class=self.queue.effective_class(e, tick),
                cost_ns=min(pc.hop_ns + pc.place_ns for pc in pcs),
                fast_resident=e.uid in fast_uids))

        budget = self.cfg.max_wave or len(cands)
        victims: List[VictimCand] = []
        placements: List[AdmitCand] = []
        targets: List[int] = []
        picked_uids: set = set()
        victim_order: Optional[List[VictimCand]] = None
        for c in self.policy.admit_order(cands, ctx):
            if len(placements) >= budget:
                break
            if c.entry.uid in picked_uids:
                continue
            chosen: Optional[int] = None
            victim: Optional[VictimCand] = None
            cands_now = [pc._replace(free_slots=free[pc.replica])
                         for pc in place_cache[id(c.entry)]]
            for pc in self.policy.place_order(cands_now, ctx):
                if free[pc.replica] > 0:
                    chosen = pc.replica
                    break
                if self.cfg.preempt:
                    if victim_order is None:
                        victim_order = self.policy.victim_order(
                            self._victim_cands(fast_uids), ctx)
                    victim = next(
                        (v for v in victim_order if v not in victims
                         and v.priority > c.eff_class
                         and self.cluster.replica_of(v.slot) == pc.replica),
                        None)
                    if victim is not None:
                        chosen = pc.replica
                        break
            if chosen is None:
                # unlike the single-engine case, unplaceable is per-
                # candidate (a migration-off resume may be pinned to a full
                # replica while others are open) — skip, don't give up
                continue
            if victim is not None:
                victims.append(victim)
            else:
                free[chosen] -= 1
            placements.append(c)
            targets.append(chosen)
            picked_uids.add(c.entry.uid)
        return ClusterWave(victims=tuple(v.slot for v in victims),
                           placements=tuple(placements),
                           targets=tuple(targets))

    # ---- wave execution ---------------------------------------------------
    def _execute_wave(self, wave: ClusterWave, fast_uids: frozenset,
                      lanes: Optional[List[float]] = None) -> float:
        cl = self.cluster
        if lanes is None:       # direct callers (tests): fresh lanes
            lanes = [0.0] * cl.n_replicas
        t0 = self.now_ns        # lane origin: all lane values are offsets
        spos = self.eng.session_pos          # one merged snapshot per phase
        active = self.eng.active
        pairs = [(c, t) for c, t in zip(wave.placements, wave.targets)
                 if c.entry.kind == "fresh" or c.entry.uid in spos]

        # keep only the victims still needed: completions during the
        # overlapped decode may have freed slots on a placement's replica,
        # and a context-exhausted resume (no room left) completes without
        # ever taking a slot — neither justifies a preemption
        free = cl.free_by_replica()
        need: Dict[int, int] = {}
        for c, t in pairs:
            if (c.entry.kind == "resume"
                    and self.eng.max_len - spos[c.entry.uid] < 1):
                continue
            need[t] = need.get(t, 0) + 1
        victims = []
        for g in wave.victims:
            if g not in active:
                continue
            r = cl.replica_of(g)
            if need.get(r, 0) > free[r]:
                victims.append(g)
                free[r] += 1
        if victims:
            requeue = []
            for g in victims:
                job = self._slot_job.pop(g)
                req = active[g]
                job.done += len(req.generated) - job.seed_tokens
                job.state, job.slot = "queued", -1
                self._last_active[job.uid] = self.tick_count
                requeue.append(job)
            cl.suspend_many(victims)        # one fused dispatch per replica
            self._charge_wave("preempt_suspend",
                              [j.uid in fast_uids for j in requeue],
                              "suspend",
                              lanes=[cl.replica_of(g) + 1 for g in victims])
            for g, job in zip(victims, requeue):
                self._lane_add(lanes, cl.replica_of(g), job.uid,
                               self._move_ns("suspend",
                                             job.uid in fast_uids), t0)
            for job in requeue:
                self.queue.push(job_id=job.job_id, uid=job.uid,
                                kind="resume", priority=job.priority,
                                arrival_ns=job.arrival_ns, slo_ns=job.slo_ns,
                                tick=self.tick_count,
                                new_tokens=job.target_new - job.done,
                                seq=job.job_id)

        # resumes: migrate off-home sessions (one fused plan per route),
        # then ONE fused resume_many wave per replica.  Fresh snapshot:
        # the preemption suspends above can evict colliding store indices
        spos = self.eng.session_pos
        resumes = [(c, t) for c, t in pairs if c.entry.kind == "resume"
                   and c.entry.uid in spos]
        ready, extras, rtargets = [], [], []
        for c, t in resumes:
            room = self.eng.max_len - spos[c.entry.uid]
            n = min(c.entry.new_tokens, room)
            job = self._jobs[c.entry.job_id]
            if n < 1:
                self.queue.remove(c.entry)
                job.target_new = job.done       # context exhausted
                self._complete_job(job, self.now_ns + lanes[t])
                continue
            job.target_new -= c.entry.new_tokens - n
            ready.append(c)
            extras.append(n + 1)                # +1: the restored seed token
            rtargets.append(t)
        inj = self.faults
        if inj is not None and ready:
            # pre-resume repair: a session the ledger knows is corrupt at
            # rest is restored from its snapshot BEFORE it resumes (clean
            # bytes migrate/resume below); without recovery — or without a
            # snapshot — it resumes as-is and the device-side verify counts
            # the detection (served corrupt, never silent)
            for c in ready:
                uid = c.entry.uid
                # fork-aware: corruption lives on the PHYSICAL row, so the
                # incident may be ledgered under a sibling alias of the
                # row this resume is about to read
                fam = self._family(uid)
                marked = [f for f in fam if inj.is_corrupt(f)]
                if not marked:
                    continue
                home = cl.residence[uid]
                rc = None
                if inj.spec.recover:
                    if len(fam) > 1:
                        # a SHARED row heals in place from any family
                        # member's pages-bearing snapshot (aliases are
                        # meta-only): restore_session would re-admit the
                        # carrier and demote the corrupt row to the
                        # siblings, repairing one alias instead of all
                        snap = next(
                            (self._snaps[f] for f in fam
                             if f in self._snaps
                             and self._snaps[f].pages is not None), None)
                        if snap is not None:
                            rc = repair_row(cl, snap, home)
                    else:
                        snap = self._snaps.get(uid)
                        if snap is not None:
                            rc = restore_session(cl, snap, home)
                if rc is not None:
                    self._lane_add(lanes, home, uid, self._mech_ns(rc), t0)
                    self.metrics.record_decision(Decision(
                        tick=self.tick_count, kind="recover_wave",
                        n_items=len(marked), ns_lisa=rc.ns_lisa,
                        ns_memcpy=rc.ns_memcpy, uj_lisa=rc.uj_lisa,
                        uj_memcpy=rc.uj_memcpy))
                    if self.trace.enabled:
                        cs = (rc.ns_lisa, rc.ns_memcpy,
                              rc.uj_lisa, rc.uj_memcpy)
                        self.trace.move_span(
                            "recover_wave", home + 1, cs,
                            [("restore", cs, {"uid": uid})],
                            attrs={"direction": "repair", "decision":
                                   len(self.metrics.decisions) - 1})
                    for f in marked:
                        inj.consume_corrupt(f, "recovered")
                        self.metrics.record_fault("recovered",
                                                  self._class_of(f))
                else:
                    # served corrupt; the device verify counts the read.
                    # NB an unrepaired shared row can be read by several
                    # aliases (one incident, many corrupt serves), so in
                    # the no-recovery/no-snapshot corner the device
                    # counter can exceed ledger ``detected``
                    for f in marked:
                        inj.consume_corrupt(f, "detected")
                        self.metrics.record_fault("detected",
                                                  self._class_of(f))
        if ready:
            homes = {c.entry.uid: cl.residence[c.entry.uid] for c in ready}
            migs = [(c, t) for c, t in zip(ready, rtargets)
                    if homes[c.entry.uid] != t]
            if migs:
                tot = [0.0, 0.0, 0.0, 0.0]
                for c, t in migs:
                    src = homes[c.entry.uid]
                    mplan = cl.migration_plan(src, t)
                    mc = mplan.cost
                    ns = (mc.ns_lisa if self.cfg.mechanism == "lisa"
                          else mc.ns_memcpy)
                    # the inbound replica waits for the hop chain; the
                    # source end only runs the (free) page gather — its
                    # decode lane is not stalled by an outbound migration
                    self._lane_add(lanes, t, c.entry.uid, ns, t0)
                    for i, v in enumerate((mc.ns_lisa, mc.ns_memcpy,
                                           mc.uj_lisa, mc.uj_memcpy)):
                        tot[i] += v
                    self._jobs[c.entry.job_id].migrations += 1
                    if self.trace.enabled:
                        items = [(leg.kind,
                                  (lc.ns_lisa, lc.ns_memcpy,
                                   lc.uj_lisa, lc.uj_memcpy),
                                  {"bytes": lc.bytes, "hops": lc.hops})
                                 for leg, lc in zip(
                                     mplan.legs,
                                     MV.leg_costs(mplan, cl.spec))]
                        # the migrate_wave Decision lands after the loop,
                        # at the CURRENT ledger length
                        self.trace.move_span(
                            "migrate_wave", t + 1,
                            (mc.ns_lisa, mc.ns_memcpy,
                             mc.uj_lisa, mc.uj_memcpy), items,
                            attrs={"uid": c.entry.uid,
                                   "src": src, "dst": t, "decision":
                                   len(self.metrics.decisions)})
                self.metrics.record_decision(Decision(
                    tick=self.tick_count, kind="migrate_wave",
                    n_items=len(migs), ns_lisa=tot[0], ns_memcpy=tot[1],
                    uj_lisa=tot[2], uj_memcpy=tot[3]))
            slots = cl.resume_many([c.entry.uid for c in ready], extras,
                                   rtargets)
            for c, slot in zip(ready, slots):
                self._activate(c.entry, slot, seed_tokens=1)
            flags = [c.fast_resident and homes[c.entry.uid] == t
                     for c, t in zip(ready, rtargets)]
            self._charge_wave("resume_wave", flags, "resume",
                              lanes=[t + 1 for t in rtargets])
            for c, t, f in zip(ready, rtargets, flags):
                self._lane_add(lanes, t, c.entry.uid,
                               self._move_ns("resume", f), t0)
            if inj is not None:
                # migration-wave faults: each retried route's re-copies
                # (k× the route plan) and the bounded-exponential backoff
                # are real latency on the inbound lane — but only the
                # re-copies are MOVEMENT; backoff is its own bucket
                for ev in cl.drain_fault_events():
                    retries = int(ev["retries"])
                    if retries:
                        base = cl.migration_plan(ev["src"], ev["dst"],
                                                 ev["k"]).cost
                        rc = MV.retry_cost(base, retries)
                        backoff = float(ev["backoff_ns"])
                        dst = ev["dst"]
                        svc = self._mech_ns(rc)
                        if self.mux.enabled:
                            # retries re-queue through the multiplexer on
                            # the banks of the route's sessions: each
                            # session's re-copied share occupies its own
                            # bank, so re-copies overlap across banks but
                            # contend with everything else on them
                            ruids = tuple(ev.get("uids") or ()) or (dst,)
                            share = svc / len(ruids)
                            ready_t = t0 + lanes[dst]
                            end = ready_t
                            for u in ruids:
                                start, e = self.mux.submit(
                                    self.mux.bank_of(u), ready_t, share)
                                if start > ready_t:
                                    self.metrics.record_stall(
                                        "contention", start - ready_t)
                                end = max(end, e)
                            lanes[dst] = (end - t0) + backoff
                        else:
                            # the re-copies AND the bounded-exponential
                            # backoff are real latency on the inbound lane
                            lanes[dst] += svc + backoff
                        # ledger: pure movement under both mechanisms; the
                        # mechanism-independent backoff rides in its own
                        # bucket so the lisa/memcpy advantage ratio stays
                        # fault-rate-invariant
                        self.metrics.record_decision(Decision(
                            tick=self.tick_count, kind="retry_wave",
                            n_items=retries, ns_lisa=rc.ns_lisa,
                            ns_memcpy=rc.ns_memcpy, uj_lisa=rc.uj_lisa,
                            uj_memcpy=rc.uj_memcpy, backoff_ns=backoff))
                        self.metrics.record_fault("retries", n=retries)
                        if self.trace.enabled and backoff > 0.0:
                            self.trace.emit(
                                "backoff", backoff, lane=dst + 1,
                                cat="stall", attrs={"retries": retries})
                        if self.trace.enabled:
                            bplan = cl.migration_plan(ev["src"], ev["dst"],
                                                      ev["k"])
                            items = [(leg.kind,
                                      (lc.ns_lisa * retries,
                                       lc.ns_memcpy * retries,
                                       lc.uj_lisa * retries,
                                       lc.uj_memcpy * retries),
                                      {"bytes": lc.bytes * retries,
                                       "hops": lc.hops})
                                     for leg, lc in zip(
                                         bplan.legs,
                                         MV.leg_costs(bplan, cl.spec))]
                            # trailing backoff leg: mechanism-independent
                            # wait; move_span's residual prices it exactly
                            items.append(("backoff", (0.0, 0.0, 0.0, 0.0),
                                          {"bytes": 0, "hops": 0}))
                            self.trace.move_span(
                                "retry_wave", ev["dst"] + 1,
                                (rc.ns_lisa, rc.ns_memcpy,
                                 rc.uj_lisa, rc.uj_memcpy), items,
                                attrs={"retries": retries,
                                       "src": ev["src"], "dst": ev["dst"],
                                       "backoff_ns":
                                           float(ev["backoff_ns"]),
                                       "decision":
                                           len(self.metrics.decisions)
                                           - 1})
                    uid = ev["corrupt_uid"]
                    if uid is not None:
                        # landed corrupt (retries exhausted or recovery
                        # off) and resumed in this very wave — the device
                        # verify caught it; close the incident as detected
                        inj.consume_corrupt(uid, "detected")
                        self.metrics.record_fault("detected",
                                                  self._class_of(uid))

        # fresh admissions: prefills run concurrently across replicas
        for c, t in pairs:
            if c.entry.kind != "fresh":
                continue
            e = c.entry
            job = self._jobs[e.job_id]
            budget = min(e.new_tokens, self.eng.max_len - len(e.prompt) + 1)
            job.target_new -= e.new_tokens - budget
            req = Request(uid=e.uid, prompt=e.prompt, max_new=budget,
                          arrival_ns=e.arrival_ns, priority=e.priority,
                          slo_ns=e.slo_ns)
            gslot = cl.submit(req, replica=t)
            lanes[t] += self.cfg.prefill_ns_per_token * len(e.prompt)
            self.trace.emit(
                "prefill", self.cfg.prefill_ns_per_token * len(e.prompt),
                lane=t + 1, cat="prefill",
                attrs={"uid": e.uid, "prompt_tokens": len(e.prompt)})
            self.metrics.record_decision(Decision(
                tick=self.tick_count, kind="submit", n_items=1))
            if gslot in self.eng.active:
                self._activate(e, gslot, seed_tokens=0)
            else:                   # 1-token job: completed at prefill
                self.queue.remove(e)
                job.done += len(req.generated)
                self._charge_wave("complete_suspend",
                                  [job.uid in fast_uids], "suspend",
                                  lanes=[t + 1])
                self._lane_add(lanes, t, job.uid,
                               self._move_ns("suspend",
                                             job.uid in fast_uids), t0)
                self._complete_job(job, self.now_ns + lanes[t])
        return max(lanes) if lanes else 0.0
