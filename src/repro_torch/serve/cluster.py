# Port of src/repro/serve/cluster.py in torch.  Without a counterpart:
# compile_counts (no jit to count).  The route executor is a plain function
# over the migration plan, and the fleet's engines share one copy of the
# weights on the device (as the reference's share replica 0's jits).
"""Multi-replica serving: N engines in one process, with live session
migration.

LISA links adjacent subarrays so a row can hop across the chip at full
internal bandwidth instead of draining through the narrow channel (PAPER.md
Sec. 3).  A serving fleet has the same shape one level up: each replica is a
"subarray" holding sessions (suspended KV snapshots in its VILLA tiered
store), the mesh is the inter-subarray link fabric, and the host path is the
narrow channel:

  * **replica placement ↔ subarray distance** — replicas sit on a
    :class:`~repro_torch.core.lisa.topology.MeshTopology` ring; moving a
    session from replica ``i`` to ``j`` costs ``hops(i, j)`` hops, priced by
    the same :func:`~repro_torch.core.lisa.topology.ici_dram_spec` Table-1
    model that prices every other movement.
  * **live migration ↔ RBM hop chain** — a migration is a
    :class:`~repro_torch.movement.plan.MovementPlan` (page gather out of the
    source replica's slow pool → ``hop_chain`` → page scatter into the
    destination pool), planned per route and priced as ONE copy.  It is
    loss-free and bit-exact: the pages are dtype-preserving uint8, and the
    session's host bookkeeping (position, seed token) travels with them.
  * **migration waves ↔ fused row moves** — a rebalance burst groups
    sessions by route; each route is ONE page gather (K2) and ONE page
    scatter (K1) over a page table that joins the sessions' pages.

The cluster is single-process: the replicas' pools are separate tensors on
one device, so the hop-chain leg executes as the priced route
(``local_fabric`` mode, an identity on the bytes) while the gather and
scatter legs carry them.  A mesh's ppermute chain is ROADMAP item 16.  The
cluster exposes an engine-shaped surface over *global* slot ids
(``replica * slots_per_replica + local_slot``) — the scheduler
(:class:`repro_torch.sched.scheduler.ClusterScheduler`) drives it exactly
like an engine, plus the placement axis.

Device: the fleet runs on ``cuda`` unless ``device="cpu"`` is passed; it
raises without a GPU otherwise.  The parameters are moved to the device
once and every replica's engine holds that one copy.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import movement as MV
from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dram.spec import DDR3_1600, DramSpec
from repro_torch.core.dram.villa import VillaConfig
from repro_torch.core.lisa.topology import MeshTopology
from repro_torch.faults.inject import install_fault_backends
from repro_torch.faults.spec import NULL_FAULT, FaultInjector
from repro_torch.serve.engine import (Engine, EngineFull, Request,
                                      UnknownSession, _tree_to)


class Cluster:
    """N identically-configured :class:`Engine` replicas on a mesh ring."""

    def __init__(self, cfg: ModelConfig, params, *, n_replicas: int,
                 slots: int = 4, max_len: int = 128, n_sessions: int = 64,
                 villa: Optional[VillaConfig] = None,
                 spec: DramSpec = DDR3_1600,
                 topo: Optional[MeshTopology] = None, axis: str = "replica",
                 faults: Optional[FaultInjector] = None, device=None):
        if n_replicas < 1:
            raise ValueError(f"need at least one replica (got {n_replicas})")
        self.device = resolve_device(device)
        # Chaos mode: interpose the fault wrappers, so migration waves
        # honor their ``fault`` operand.  Without an injector the same
        # route runs with NULL_FAULT.
        self.faults = faults
        if faults is not None:
            install_fault_backends()
        self.cfg = cfg
        self.n_replicas = n_replicas
        self.slots_per_replica = slots
        self.slots = n_replicas * slots
        self.max_len = max_len
        self.spec = spec
        self.axis = axis
        self.topo = topo or MeshTopology(n_replicas)
        if self.topo.size != n_replicas:
            raise ValueError(f"topology size {self.topo.size} != "
                             f"n_replicas {n_replicas}")
        # one copy of the weights on the device: each Engine's ``.to`` of a
        # tensor already there returns that tensor
        params = _tree_to(params, self.device)
        self.replicas: List[Engine] = [
            Engine(cfg, params, slots=slots, max_len=max_len,
                   n_sessions=n_sessions, villa=villa, spec=spec,
                   replica_id=r, device=self.device)
            for r in range(n_replicas)]
        e0 = self.replicas[0]
        self.villa_cfg = e0.villa_cfg
        self.page_spec = e0.page_spec
        self.n_sessions = e0.n_sessions
        self.plan_suspend = e0.plan_suspend
        self.plan_resume = e0.plan_resume
        self.snapshot_bytes = e0.snapshot_bytes
        # uid -> replica whose slow pool holds the suspended snapshot
        self.residence: Dict[int, int] = {}
        self.cluster_stats = {"migrations": 0, "migration_waves": 0,
                              "migrated_bytes": 0,
                              "modeled_migration_ns_lisa": 0.0,
                              "modeled_migration_ns_memcpy": 0.0,
                              "migration_retries": 0, "replica_failures": 0,
                              "retry_ns_lisa": 0.0, "retry_ns_memcpy": 0.0,
                              "retry_backoff_ns": 0.0,
                              "fork_materializations": 0}
        self._route_plans: Dict[Tuple, MV.MovementPlan] = {}
        self._fault_events: List[Dict[str, object]] = []
        self.tracer = None              # set by attach_tracer (repro_torch.obs)

    # ---- global slot ids ---------------------------------------------------
    def _gslot(self, replica: int, slot: int) -> int:
        return replica * self.slots_per_replica + slot

    def replica_of(self, gslot: int) -> int:
        return gslot // self.slots_per_replica

    def _local(self, gslot: int) -> int:
        return gslot % self.slots_per_replica

    # ---- engine-shaped aggregate views --------------------------------------
    @property
    def active(self) -> Dict[int, Request]:
        out: Dict[int, Request] = {}
        for r, eng in enumerate(self.replicas):
            for s, req in eng.active.items():
                out[self._gslot(r, s)] = req
        return out

    @property
    def session_pos(self) -> Dict[int, int]:
        return {uid: self.replicas[r].session_pos[uid]
                for uid, r in self.residence.items()
                if uid in self.replicas[r].session_pos}

    def free_slots(self) -> List[int]:
        return [self._gslot(r, s) for r, eng in enumerate(self.replicas)
                for s in eng.free_slots()]

    def free_by_replica(self) -> List[int]:
        return [len(eng.free_slots()) for eng in self.replicas]

    @property
    def stats(self) -> Dict[str, object]:
        out: Dict[str, object] = dict(self.cluster_stats)
        for eng in self.replicas:
            for k, v in eng.stats.items():
                out[k] = out.get(k, 0) + v
        return out

    def attach_tracer(self, tracer) -> None:
        """Attach a :class:`repro_torch.obs.Tracer` fleet-wide: replica
        ``r``'s session lifecycle events land on trace lane ``1 + r`` (the
        scheduler's per-replica lane convention)."""
        self.tracer = tracer
        for r, eng in enumerate(self.replicas):
            eng.attach_tracer(tracer, lane=1 + r)

    def fast_resident_uids(self) -> frozenset:
        out: set = set()
        for eng in self.replicas:
            out |= eng.fast_resident_uids()
        return frozenset(out)

    def fast_occupancy(self) -> List[float]:
        """Per-replica VILLA fast-tier occupancy (fraction of fast slots
        holding a live snapshot) — a placement signal: an overfull fast
        tier means inbound sessions will resume at slow-tier timings.  One
        small device->host read of each replica's tags."""
        out = []
        for eng in self.replicas:
            tags = eng.sessions.policy.tags.cpu().tolist()
            live = sum(1 for t in tags if t >= 0 and t in eng.store_uid)
            out.append(live / max(len(tags), 1))
        return out

    def hit_rate(self) -> float:
        hits = sum(int(eng.sessions.hits) for eng in self.replicas)
        acc = sum(int(eng.sessions.accesses) for eng in self.replicas)
        return hits / acc if acc else 0.0

    # ---- decode ------------------------------------------------------------
    def step_begin(self):
        """ONE fused decode per replica with live work (queued back to back
        without a sync — the replicas decode in parallel)."""
        handles = [eng.step_begin() for eng in self.replicas]
        return None if all(h is None for h in handles) else handles

    def step_end(self, handles) -> List[Tuple[int, Request]]:
        if handles is None:
            return []
        completed: List[Tuple[int, Request]] = []
        for r, (eng, h) in enumerate(zip(self.replicas, handles)):
            for s, req in eng.step_end(h):
                self.residence[req.uid] = r      # auto-suspended here
                completed.append((self._gslot(r, s), req))
        return completed

    def step(self) -> List[Tuple[int, Request]]:
        return self.step_end(self.step_begin())

    # ---- admission / suspension ---------------------------------------------
    def submit(self, req: Request, replica: Optional[int] = None) -> int:
        """Prefill-admit a fresh request onto ``replica`` (the scheduler's
        placement decision; default = first replica with a free slot)."""
        if replica is None:
            replica = next((r for r, eng in enumerate(self.replicas)
                            if eng.free_slots()), None)
            if replica is None:
                raise EngineFull(f"all {self.slots} cluster slots busy")
        eng = self.replicas[replica]
        slot = eng.submit(req)
        if slot not in eng.active:               # completed at prefill
            self.residence[req.uid] = replica
        return self._gslot(replica, slot)

    def suspend(self, gslot: int) -> None:
        self.suspend_many([gslot])

    def suspend_many(self, gslots: Sequence[int]) -> None:
        """Suspend a wave of global slots: grouped by replica, ONE fused
        wave per replica involved (never one per session)."""
        by_rep: Dict[int, List[int]] = {}
        for g in gslots:
            by_rep.setdefault(self.replica_of(g), []).append(self._local(g))
        for r, slots in by_rep.items():
            eng = self.replicas[r]
            uids = [eng.active[s].uid for s in slots]
            if len(slots) == 1:
                eng.suspend(slots[0])
            else:
                eng.suspend_many(slots)
            for uid in uids:
                self.residence[uid] = r

    # ---- resume (with implicit migration) ------------------------------------
    def resume(self, uid: int, extra_new: int,
               replica: Optional[int] = None) -> int:
        return self.resume_many([uid], extra_new,
                                None if replica is None else [replica])[0]

    def resume_many(self, uids: Sequence[int], extra_new,
                    replicas: Optional[Sequence[int]] = None) -> List[int]:
        """Resume a wave of sessions, each on its target replica (default:
        where it resides).  Sessions whose target differs from their
        residence are MIGRATED first — grouped by route, one gather and one
        scatter per route — then each replica's resumes run as one fused
        ``resume_many`` wave.  Returns global slots in input order."""
        if not uids:
            return []
        extras = ([int(extra_new)] * len(uids)
                  if isinstance(extra_new, (int, np.integer))
                  else [int(e) for e in extra_new])
        if len(extras) != len(uids):
            raise ValueError(f"extra_new sequence has {len(extras)} entries "
                             f"for {len(uids)} uids")
        targets = (list(replicas) if replicas is not None
                   else [self._home(u) for u in uids])
        if len(targets) != len(uids):
            raise ValueError(f"replicas sequence has {len(targets)} entries "
                             f"for {len(uids)} uids")
        moves = [(u, t) for u, t in zip(uids, targets)
                 if self._home(u) != t]
        if moves:
            self.migrate_many(moves)
        by_rep: Dict[int, List[int]] = {}
        for i, t in enumerate(targets):
            by_rep.setdefault(t, []).append(i)
        gslots = [0] * len(uids)
        for r, idxs in by_rep.items():
            eng = self.replicas[r]
            slots = eng.resume_many([uids[i] for i in idxs],
                                    [extras[i] for i in idxs])
            for i, s in zip(idxs, slots):
                gslots[i] = self._gslot(r, s)
        return gslots

    def _home(self, uid: int) -> int:
        if uid not in self.residence:
            raise UnknownSession(
                f"uid {uid} has no suspended session on any replica")
        return self.residence[uid]

    # ---- live migration -------------------------------------------------------
    def migration_plan(self, src: int, dst: int,
                       k: int = 1) -> MV.MovementPlan:
        """The priced route plan for ``k`` sessions moving src -> dst:
        page gather -> mesh hop chain -> page scatter, ONE copy under the
        Table-1 model (the hop leg carries the payload at ICI pricing; the
        memcpy alternative is the two-leg host path)."""
        key = (src, dst, k)
        if key not in self._route_plans:
            self._route_plans[key] = MV.plan(
                MV.Transfer(MV.Tier("slow", index=src, axis=self.axis),
                            MV.Tier("slow", index=dst, axis=self.axis),
                            MV.Layout.pages(self.page_spec, batch=k)),
                self.spec, topo=self.topo)
        return self._route_plans[key]

    def hop_ns(self, src: int, dst: int, mechanism: str = "lisa") -> float:
        """Modeled one-session migration latency over the src->dst route
        under ``mechanism`` — the scheduler's placement-cost input."""
        if src == dst:
            return 0.0
        c = self.migration_plan(src, dst).cost
        return c.ns_lisa if mechanism == "lisa" else c.ns_memcpy

    def _run_route(self, s_eng: Engine, d_eng: Engine,
                   src_table: torch.Tensor, dst_table: torch.Tensor,
                   fault: np.ndarray) -> None:
        """The route executor, shared by every route: gather the sessions'
        pages out of the source pool (one K2 launch into a fresh buffer),
        scatter them into the destination pool in place (one K1 launch).
        The hop-chain leg between them is the priced mesh route (identity
        in ``local_fabric`` mode); routes differ only in pricing, so one
        plan serves every route.  ``fault`` is the host (mode, index, xor)
        chaos operand — NULL_FAULT on clean runs — consumed by the
        fault-wrapped hop-chain backend when chaos mode installed the
        wrappers, and unused otherwise."""
        P, d = self.page_spec.page_rows, self.page_spec.page_lanes
        MV.execute(self.migration_plan(0, 1 % self.n_replicas),
                   src_pool=s_eng.sessions.slow.view(-1, P, d),
                   src_table=src_table,
                   dst_pool=d_eng.sessions.slow.view(-1, P, d),
                   dst_table=dst_table, local_fabric=True, fault=fault)

    def _row_table(self, rows: Sequence[int]) -> torch.Tensor:
        """The host int32 page table addressing ``rows``' pages in order:
        ``row * n_pages + arange(n_pages)`` for each row, joined."""
        spp = self.page_spec.n_pages
        arange = np.arange(spp, dtype=np.int32)
        return torch.from_numpy(
            np.concatenate([np.int32(i) * spp + arange for i in rows]))

    def migrate(self, uid: int, dst: int) -> None:
        self.migrate_many([(uid, dst)])

    def migrate_many(self, moves: Sequence[Tuple[int, int]]) -> None:
        """Migrate a burst of suspended sessions, each ``(uid, dst_replica)``.

        Sessions are grouped by (src, dst) route; each route executes as
        ONE page gather and ONE page scatter over a joined page table (the
        wave idiom of ``suspend_many``/``resume_many``), priced by one
        hop-chain plan of batch k.  Bit-exact and loss-free: uint8 pages
        plus the host bookkeeping (position, seed token) move together."""
        if not moves:
            return
        uids = [u for u, _ in moves]
        if len(set(uids)) != len(uids):
            raise ValueError(f"duplicate uids in migration wave: {uids}")
        active_uids = {r.uid for r in self.active.values()}
        routes: Dict[Tuple[int, int], List[int]] = {}
        for uid, dst in moves:
            if not 0 <= dst < self.n_replicas:
                raise ValueError(f"unknown destination replica {dst}")
            if uid in active_uids:
                raise ValueError(f"uid {uid} is active; suspend it before "
                                 f"migrating its session")
            src = self._home(uid)
            if src == dst:
                raise ValueError(f"uid {uid} already resides on replica "
                                 f"{dst}; migration needs a real route")
            routes.setdefault((src, dst), []).append(uid)

        spp = self.page_spec.n_pages
        page_bytes = self.page_spec.page_bytes
        for (src, dst), route_uids in routes.items():
            s_eng, d_eng = self.replicas[src], self.replicas[dst]
            metas = [s_eng.session_meta(u) for u in route_uids]
            src_idx = [s_eng.drop_session(u) for u in route_uids]
            dst_idx = [d_eng.adopt_session(u, p, t)
                       for u, (p, t) in zip(route_uids, metas)]
            self._invalidate_fast(d_eng, dst_idx)
            src_table = self._row_table(src_idx)
            dst_table = self._row_table(dst_idx)
            k = len(route_uids)

            inj = self.faults
            fault = (inj.draw_movement(k * spp * page_bytes, k * spp)
                     if inj is not None else NULL_FAULT)
            self._run_route(s_eng, d_eng, src_table, dst_table, fault)
            if inj is not None and int(fault[0]) != 0:
                # The injector KNOWS it corrupted this wave (host-
                # deterministic — no device read needed): retry the whole
                # route from the intact source pages, each retry a fresh
                # draw, bounded by max_retries with exponential backoff.
                # The retries and backoff are real latency — the scheduler
                # prices them into the virtual clock via
                # drain_fault_events().
                cost1 = self.migration_plan(src, dst, k).cost
                retries, backoff_total = 0, 0.0
                while (inj.spec.recover and int(fault[0]) != 0
                       and retries < inj.spec.max_retries):
                    retries += 1
                    inj.counters["retries"] += 1
                    backoff_total += inj.backoff_ns(retries)
                    fault = inj.draw_movement(k * spp * page_bytes, k * spp)
                    self._run_route(s_eng, d_eng, src_table, dst_table,
                                    fault)
                corrupt_uid = None
                if int(fault[0]) != 0:          # landed corrupt (no/lost
                    mode, index = int(fault[0]), int(fault[1])  # recovery)
                    page = (index // page_bytes if mode == 1 else index)
                    corrupt_uid = route_uids[min(page // spp, k - 1)]
                    inj.note_corrupt(corrupt_uid)
                elif retries:
                    inj.counters["retry_fixed"] += 1
                self.cluster_stats["migration_retries"] += retries
                self.cluster_stats["retry_ns_lisa"] += (
                    retries * cost1.ns_lisa)
                self.cluster_stats["retry_ns_memcpy"] += (
                    retries * cost1.ns_memcpy)
                self.cluster_stats["retry_backoff_ns"] += backoff_total
                self._fault_events.append({
                    "kind": "migration", "src": src, "dst": dst, "k": k,
                    "retries": retries, "backoff_ns": backoff_total,
                    "corrupt_uid": corrupt_uid,
                    "uids": tuple(route_uids)})
            # the checksum sidecar rows travel with the pages — computed at
            # suspend time on the SOURCE, so corruption in flight is exactly
            # what the destination's resume-time verify will catch
            d_eng.session_sums[d_eng._dev(dst_idx, torch.long)] = \
                s_eng.session_sums.index_select(
                    0, s_eng._dev(src_idx, torch.long))
            for uid in route_uids:
                self.residence[uid] = dst
            cost = self.migration_plan(src, dst, k).cost
            self.cluster_stats["migrations"] += k
            self.cluster_stats["migration_waves"] += 1
            self.cluster_stats["migrated_bytes"] += cost.bytes
            self.cluster_stats["modeled_migration_ns_lisa"] += cost.ns_lisa
            self.cluster_stats["modeled_migration_ns_memcpy"] += (
                cost.ns_memcpy)

    # ---- zero-copy forking (cluster semantics) -------------------------------
    def fork(self, parent_uid: int, child_uid: int,
             replica: Optional[int] = None,
             seed_token: Optional[int] = None) -> None:
        """Fork ``child_uid`` off a suspended parent.

        Same replica (default): a zero-copy ALIAS fork — the child
        refcounts the parent's physical row on that replica's fork table,
        zero device launches (``Engine.fork``).

        Different replica: the alias cannot span pools (refcounts are
        per-replica), so the fork MATERIALIZES — the parent's snapshot row
        is copied over the existing priced migration route (page gather ->
        hop chain -> page scatter, one K2 and one K1) into an exclusive row
        on the destination; the parent and its refcounts are untouched.
        The copy runs with NULL_FAULT deliberately: materialization is a
        fresh admission, not an in-flight session move — chaos targets
        migrations of live state, and a corrupted fork would be detected at
        the child's first resume anyway (the checksum sidecar travels).
        """
        src = self._home(parent_uid)
        dst = src if replica is None else replica
        if not 0 <= dst < self.n_replicas:
            raise ValueError(f"unknown replica {dst}")
        if child_uid in self.residence or any(
                r.uid == child_uid for r in self.active.values()):
            raise ValueError(f"child uid {child_uid} already in use")
        if dst == src:
            self.replicas[src].fork(parent_uid, child_uid, seed_token)
            self.residence[child_uid] = src
            return
        s_eng, d_eng = self.replicas[src], self.replicas[dst]
        pos, tok = s_eng.session_meta(parent_uid)
        if parent_uid in {r.uid for r in self.active.values()}:
            raise ValueError(f"parent uid {parent_uid} is active; suspend "
                             f"it before forking")
        src_phys = s_eng.forks.resolve(parent_uid)
        seed = tok if seed_token is None else int(seed_token)
        dst_idx = d_eng.adopt_session(child_uid, pos, seed)
        self._invalidate_fast(d_eng, [dst_idx])
        self._run_route(s_eng, d_eng, self._row_table([src_phys]),
                        self._row_table([dst_idx]), NULL_FAULT)
        d_eng.session_sums[dst_idx] = s_eng.session_sums[src_phys]
        self.residence[child_uid] = dst
        cost = self._fork_route_plan(src, dst).cost
        self.cluster_stats["fork_materializations"] += 1
        self.cluster_stats["migrated_bytes"] += cost.bytes
        self.cluster_stats["modeled_migration_ns_lisa"] += cost.ns_lisa
        self.cluster_stats["modeled_migration_ns_memcpy"] += cost.ns_memcpy

    def _fork_route_plan(self, src: int, dst: int) -> MV.MovementPlan:
        """The priced cross-replica ``fork``-kind plan (gather -> hop chain
        -> scatter: a materialization is a real copy, priced like the
        migration route it rides)."""
        key = ("fork", src, dst)
        if key not in self._route_plans:
            self._route_plans[key] = MV.plan(
                MV.Transfer(MV.Tier("slow", index=src, axis=self.axis),
                            MV.Tier("slow", index=dst, axis=self.axis),
                            MV.Layout.pages(self.page_spec), kind="fork"),
                self.spec, topo=self.topo)
        return self._route_plans[key]

    def shared_uids(self) -> frozenset:
        """Fleet union of per-replica shared uids (fork-aware scheduling
        input: worst victims, preferred placements)."""
        out: set = set()
        for eng in self.replicas:
            out |= eng.shared_uids()
        return frozenset(out)

    def drain_fault_events(self) -> List[Dict[str, object]]:
        """Hand the scheduler the chaos events since the last drain (retry
        latency to charge, corrupt sessions to repair or write off)."""
        out, self._fault_events = self._fault_events, []
        return out

    # ---- chaos surface ------------------------------------------------------
    def fail_replica(self, r: int) -> Tuple[List[Tuple[int, Request]],
                                            Dict[int, Tuple[int, int]]]:
        """Chaos: replica ``r`` dies.  Its slots, fast-tier tags and
        in-flight sessions are gone; its suspended snapshots are
        unreachable.  Returns what the scheduler needs for recovery:
        the ``(gslot, request)`` pairs that were in flight, and the
        ``{uid: (pos, tok)}`` bookkeeping of the suspended sessions that
        died with the pools.  The replica itself restarts empty (capacity
        returns; state does not) — re-admission goes through snapshots or
        re-prefill, never through the lost buffers."""
        if not 0 <= r < self.n_replicas:
            raise ValueError(f"unknown replica {r}")
        eng = self.replicas[r]
        inflight = [(self._gslot(r, s), eng.active[s])
                    for s in sorted(eng.active)]
        suspended = {uid: (eng.session_pos[uid], eng.session_tok[uid])
                     for uid in sorted(eng.session_pos)}
        eng.active.clear()
        eng.session_pos.clear()
        eng.session_tok.clear()
        eng.store_uid.clear()
        eng.forks.clear()       # aliases died with the rows they shared
        st = eng.sessions
        eng.sessions = st._replace(policy=st.policy._replace(
            tags=torch.full_like(st.policy.tags, -1)))
        for uid in [u for u, home in self.residence.items() if home == r]:
            del self.residence[uid]
        self.cluster_stats["replica_failures"] += 1
        return inflight, suspended

    def degrade_fast(self, r: int) -> None:
        """Chaos: replica ``r``'s VILLA fast tier degrades to slow-only
        (pricing reroutes; data-path correctness is untouched)."""
        self.replicas[r].degrade_fast()

    def verify_failure_count(self) -> int:
        """Fleet total of the device-side resume-verify counters (one
        explicit sync per replica — bench/test surface, not the tick
        loop)."""
        return sum(eng.verify_failure_count() for eng in self.replicas)

    def scrub(self) -> int:
        """End-of-run audit: device-side checksum scrub of every live
        suspended snapshot across the fleet; returns the corrupt-session
        count."""
        return sum(int(eng.verify_store()) for eng in self.replicas)

    @staticmethod
    def _invalidate_fast(eng: Engine, idxs: Sequence[int]) -> None:
        """Drop stale fast-tier residency for store indices an inbound
        migration is about to overwrite.  A local suspend writes through to
        both pools, but a migration scatters into the slow pool only — a
        fast slot still tagged with the (evicted) index would serve the
        OLD session's bytes on the next resume.  One small device->host
        read of the tags, as the reference's."""
        tags = eng.sessions.policy.tags
        stale = [i for i, t in enumerate(tags.cpu().tolist()) if t in idxs]
        if stale:
            policy = eng.sessions.policy._replace(tags=tags.index_fill(
                0, eng._dev(stale, torch.long), -1))
            eng.sessions = eng.sessions._replace(policy=policy)
