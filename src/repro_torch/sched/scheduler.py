# Port of src/repro/sched/scheduler.py:1-626 (SchedConfig, Job, Wave,
# Scheduler).  The multi-replica ClusterScheduler (:628-1426) and its fault
# recovery arrive with the cluster slice; the base Scheduler's helpers that
# only it uses (per-replica lanes, Job.migrations) are left out.
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
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from repro_torch import movement as MV
from repro_torch.core.dram.bank import RequestMultiplexer
from repro_torch.obs import NULL_TRACER
from repro_torch.sched.metrics import Decision, JobRecord, Metrics
from repro_torch.sched.policy import (AdmitCand, SchedContext, SchedPolicy,
                                      VictimCand, get_policy)
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
            self.trace.seek(0, 0.0)              # pre-seed the lane cursor
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
                     direction: str) -> float:
        """Record one fused wave of session moves as ONE decision (both
        mechanisms) and return the active-mechanism ns for the clock."""
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
            self._trace_moves(kind, direction, moves, costs,
                              len(self.metrics.decisions) - 1)
        return tot[0] if self.cfg.mechanism == "lisa" else tot[1]

    def _wave_advance(self, kind: str, moves: Sequence[bool],
                      direction: str, *, uids: Sequence[int],
                      t0: float) -> float:
        """Charge one fused wave to the ledger (isolated Table-1 pricing,
        via :meth:`_charge_wave`) and return the CLOCK advance: the
        isolated active-mechanism total when the bank model is off —
        bit-identical to the serial pre-bank clock — else the contended
        wave span through the multiplexer: every member ready at ``t0``,
        distinct banks overlapping, same-bank members serializing, starts
        pushed out of refresh windows.  Pricing never changes; only WHEN
        the wave completes does."""
        iso = self._charge_wave(kind, moves, direction)
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

    def _trace_moves(self, kind: str, direction: str,
                     moves: Sequence[bool],
                     costs: Sequence[Tuple[float, float, float, float]],
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
        for resident, mc in zip(moves, costs):
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
                kind, 0, mc, items,
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
            done_ns=job.done_ns, slo_ns=job.slo_ns, tokens=job.done))

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
