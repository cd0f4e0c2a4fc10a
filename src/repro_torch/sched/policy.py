# Port of src/repro/sched/policy.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""Pluggable victim/placement policies behind a registry.

This extends the repo's registry pattern a third time: PR 1 registered
``CopyMechanism`` objects (pricing a copy), PR 3 registered movement
*backends* (performing a copy), and this module registers *policies* —
deciding **which** copies to perform at all.  That is the paper's missing
layer: LISA/RowClone make bulk movement cheap, but the win only materializes
when a controller schedules the cheap path instead of the naive one.

A policy orders two candidate lists (it never mutates engine or queue):

  * ``admit_order``  — queued entries (fresh prefills + session resumes),
    best-placed-first;
  * ``victim_order`` — active slots eligible for preemption, best-victim
    first.

``fifo`` is the pre-scheduler baseline (arrival order, lowest slot index
victim — exactly the arbitrary choice ``launch/serve.py`` used to hard-code).
``lru`` victimizes the least-recently-activated session.  ``cost_aware``
consults the modeled movement bill: admissions run earliest-deadline-first
within an effective class with cheap (VILLA fast-tier resident) resumes
breaking ties, and victims are the sessions whose suspend is cheapest under
the active :class:`~repro_torch.core.dram.spec.DramSpec` mechanism — a session
resident in the fast tier pays the write-through to *both* pools, so the
cheap-to-suspend session is also the cold one worth displacing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Sequence, Tuple

from repro_torch.sched.queue import QueueEntry


class AdmitCand(NamedTuple):
    """A queued entry the scheduler could place this tick."""
    entry: QueueEntry
    eff_class: int          # aged class at this tick (can be negative)
    cost_ns: float          # modeled placement cost (resume move / prefill)
    fast_resident: bool     # resume target resident in the VILLA fast tier


class VictimCand(NamedTuple):
    """An active slot the scheduler could preempt this tick."""
    slot: int
    uid: int
    priority: int           # the running job's nominal class
    last_active_tick: int   # activation tick (LRU signal)
    suspend_ns: float       # modeled suspend cost under the active mechanism
    fast_resident: bool
    # the session's snapshot row is aliased by other (forked) sessions:
    # evicting it forces a shared-row demotion and hurts every alias, so
    # shared sessions are structurally the WORST victims
    shared: bool = False


class PlaceCand(NamedTuple):
    """One replica a cluster placement could land on — the third decision
    axis (beside admission and eviction).  ``hop_ns`` is the modeled
    migration cost from the session's current residence to this replica
    (0 for fresh requests and for the home replica); ``place_ns`` the
    modeled resume/prefill cost once there."""
    replica: int
    free_slots: int         # open slots on the replica right now
    fast_occupancy: float   # fraction of the VILLA fast tier in use
    hop_ns: float
    place_ns: float
    degraded: bool = False  # VILLA fast tier degraded to slow-only (chaos)
    # the placed session's fork family already resides here: landing on
    # this replica keeps the fork an alias (zero-copy) instead of a
    # cross-replica materialization
    shared_resident: bool = False


@dataclasses.dataclass(frozen=True)
class SchedContext:
    """Read-only facts policies may consult."""
    tick: int
    now_ns: float
    mechanism: str                      # "lisa" | "memcpy"
    fast_uids: frozenset = frozenset()  # sessions resident in the fast tier


class SchedPolicy:
    """Base policy: effective-class order, FIFO within class, slot-order
    victims.  Subclasses override the sort keys only — determinism and
    starvation freedom (aging drives ``eff_class`` below any fresh class)
    come from the shared structure."""

    name = "base"

    def admit_order(self, cands: Sequence[AdmitCand],
                    ctx: SchedContext) -> List[AdmitCand]:
        return sorted(cands, key=lambda c: (c.eff_class, c.entry.seq))

    def victim_order(self, cands: Sequence[VictimCand],
                     ctx: SchedContext) -> List[VictimCand]:
        return sorted(cands, key=lambda c: c.slot)

    def place_order(self, cands: Sequence[PlaceCand],
                    ctx: SchedContext) -> List[PlaceCand]:
        """Replica preference for one placement (cluster scheduling only):
        base policies spread by free slots and ignore the movement bill."""
        return sorted(cands, key=lambda c: (-c.free_slots, c.replica))


class FifoPolicy(SchedPolicy):
    """Arrival order, arbitrary (lowest-index) victim — the baseline the
    paper's controller-scheduling argument is made against."""
    name = "fifo"


class LruPolicy(SchedPolicy):
    """FIFO admissions, least-recently-activated victim (classic working-set
    heuristic, blind to movement cost)."""
    name = "lru"

    def victim_order(self, cands, ctx):
        return sorted(cands, key=lambda c: (-c.priority, c.last_active_tick,
                                            c.slot))


class CostAwarePolicy(SchedPolicy):
    """Every ordering consults the movement bill.

    Admissions: effective class; then jobs that can still *make* their
    deadline before jobs whose deadline has already passed (plain EDF
    suffers domino misses under overload — a hopeless job must not starve a
    saveable one); then earliest deadline; then modeled placement cost — a
    fast-tier-hit resume (cheap lisa-priced move) is preferred over a
    slow-tier miss at equal urgency.  Victims: lowest-priority first, then
    cheapest modeled suspend — non-resident (cold) sessions cost one
    slow-pool write, resident (hot) ones pay the fast-pool write-through on
    top, so the policy structurally keeps hot sessions on slots.
    """
    name = "cost_aware"

    def admit_order(self, cands, ctx):
        def key(c: AdmitCand):
            hopeless = ctx.now_ns > c.entry.deadline_ns
            return (c.eff_class, hopeless, c.entry.deadline_ns, c.cost_ns,
                    c.entry.seq)
        return sorted(cands, key=key)

    def victim_order(self, cands, ctx):
        # ``shared`` before the cost keys: preempting a forked session
        # whose row other aliases still read forces a demotion clone and
        # cools the whole family — only ever the last resort
        return sorted(cands, key=lambda c: (-c.priority, c.shared,
                                            c.suspend_ns,
                                            c.last_active_tick, c.slot))


class CostAwareClusterPolicy(CostAwarePolicy):
    """``cost_aware`` plus a movement-priced placement axis.

    Placement scores every replica by (free slots, modeled movement bill,
    VILLA fast-tier occupancy): a replica with an open slot always beats
    one that needs preemption; among those, the cheapest total move wins —
    ``hop_ns`` (the ICI hop-chain price of migrating the session from its
    residence, 0 at home) plus the resume/prefill cost — and a less
    pressured fast tier breaks ties (an overfull fast tier means the
    inbound session will keep resuming at slow-subarray timings).  This is
    the paper's Sec. 3.2 "intelligent cost-aware mechanism" applied to
    replica topology: distance-1 neighbors are preferred over far hops
    exactly as LISA prefers near-subarray RBM chains.

    A chaos-degraded replica (fast tier offline) sorts behind healthy ones
    at equal slot pressure: its ``place_ns`` already reroutes to slow-tier
    pricing (the engine reports no fast residents while degraded), and the
    explicit ``degraded`` key keeps new sessions off it even when the
    priced costs tie."""
    name = "cost_aware_cluster"

    def place_order(self, cands, ctx):
        # ``not shared_resident`` ahead of the priced keys: a replica
        # already holding the session's fork family serves it by alias
        # (zero-copy) — cheaper than any hop the cost model can quote
        return sorted(cands, key=lambda c: (c.free_slots <= 0, c.degraded,
                                            not c.shared_resident,
                                            c.hop_ns + c.place_ns,
                                            c.fast_occupancy, c.replica))


_POLICIES: Dict[str, SchedPolicy] = {}


def register_policy(policy: SchedPolicy) -> SchedPolicy:
    """Register a policy instance under ``policy.name``.  Re-registering the
    same class (module reload) replaces silently; a different class under a
    taken name raises — the CopyMechanism/backend registry contract."""
    old = _POLICIES.get(policy.name)
    if old is not None and (type(old).__module__, type(old).__qualname__) != (
            type(policy).__module__, type(policy).__qualname__):
        raise ValueError(f"scheduling policy {policy.name!r} already "
                         f"registered by {type(old).__qualname__}")
    _POLICIES[policy.name] = policy
    return policy


def get_policy(name) -> SchedPolicy:
    """Look up a policy by name (a :class:`SchedPolicy` passes through)."""
    if isinstance(name, SchedPolicy):
        return name
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown scheduling policy {name!r} "
                         f"(known: {sorted(_POLICIES)})") from None


def policies() -> Tuple[str, ...]:
    return tuple(sorted(_POLICIES))


register_policy(FifoPolicy())
register_policy(LruPolicy())
register_policy(CostAwarePolicy())
register_policy(CostAwareClusterPolicy())
