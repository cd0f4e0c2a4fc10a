# Port of src/repro/movement/plan.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""`Transfer` -> `plan()` -> `MovementPlan`: one movement substrate.

LISA's claim is that a single low-cost substrate (interlinked subarrays)
serves *many* applications — RISC bulk copy, VILLA caching, LIP precharging
— through one shared mechanism.  This module is that substrate at the
system level: every bulk transfer in the repo (serving suspend/resume,
tier promotion, checkpoint staging, pipeline stage hops, dense bulk copies)
is expressed as a :class:`Transfer` between *tiers*, lowered by
:func:`plan` against a :class:`~repro_torch.core.dram.spec.DramSpec` topology
into a typed :class:`MovementPlan` of legs, and executed through the
backend registry (:mod:`repro_torch.movement.registry`).

The lowering mirrors the paper's structure:

  * page gather/scatter legs  — LISA-RISC row movement (the Pallas kernels
    ``villa_gather`` / ``villa_scatter`` with scalar-prefetched tables);
  * tier read/write legs      — VILLA policy-mediated movement (hot-marking
    and promotion decide *what* moves; the page legs move it);
  * hop-chain legs            — inter-device ``ppermute`` chains over a mesh
    axis (``rbm.rbm_hop`` / ``rbm.lisa_copy``), cost linear in hops;
  * tile-copy legs            — intra-device HBM->HBM movement through VMEM
    (``rbm_copy``, LIP double buffering);
  * host-staging legs         — the off-chip channel (checkpoint save /
    restore), the "memcpy" path every in-fabric leg is priced against;
  * pack/unpack legs          — dtype-preserving uint8 page staging
    (:mod:`repro_torch.movement.paging`); zero-cost relabeling, not movement.

Every plan carries a :class:`MovementCost` — true payload bytes, hop count,
and modeled latency/energy under both the LISA hop-chain mechanism and the
channel memcpy mechanism, priced through the spec's ``CopyMechanism``
registry — so callers account movement the same way the DRAM model does
(Table 1 at system granularity).  Batched waves are expressed with
``Layout(batch=k)`` (or :func:`fuse`) and lower to ONE dispatch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dram.spec import DDR3_1600, DramSpec
from repro_torch.core.dram.villa import VillaConfig
from repro_torch.movement.paging import PageSpec

if TYPE_CHECKING:                       # pragma: no cover
    from repro_torch.core.lisa.topology import MeshTopology

# repro_torch.core.lisa.topology is imported lazily (function scope): its package
# __init__ pulls in villa_cache, which itself registers backends with this
# movement package — a module-level import here would be circular.

TIER_KINDS = ("compute", "fast", "slow", "device", "host", "stage")


@dataclasses.dataclass(frozen=True)
class Tier:
    """One end of a transfer.

    kind:  "compute" — live working state on device (KV cache, activations)
           "fast"    — VILLA fast tier (hot working set)
           "slow"    — VILLA slow/bulk tier (paged session pool)
           "device"  — whole-device dense storage (bulk arrays)
           "host"    — host memory across the off-chip channel
           "stage"   — a position on a named mesh axis (pipeline stage /
                       mesh neighbor); ``index`` optional (None = shift mode)
    """
    kind: str
    index: Optional[int] = None
    axis: Optional[str] = None

    def __post_init__(self):
        if self.kind not in TIER_KINDS:
            raise ValueError(f"unknown tier kind {self.kind!r} "
                             f"(known: {TIER_KINDS})")


@dataclasses.dataclass(frozen=True)
class Layout:
    """Static shape/byte description of the payload (dtype-preserving:
    ``nbytes`` is always true bytes, never a float32 upcast)."""
    kind: str                           # "pages" | "dense" | "tree"
    nbytes: int                         # true payload bytes PER ITEM
    batch: int = 1                      # items moving as one fused wave
    page_spec: Optional[PageSpec] = None
    shape: Tuple[int, ...] = ()
    dtype_name: str = ""

    @classmethod
    def pages(cls, page_spec: PageSpec, batch: int = 1) -> "Layout":
        """A paged pytree snapshot (one cache slot) staged via PageSpec."""
        return cls(kind="pages", nbytes=page_spec.total_bytes, batch=batch,
                   page_spec=page_spec)

    @classmethod
    def raw_pages(cls, n_pages: int, page_rows: int, page_lanes: int,
                  dtype, batch: int = 1) -> "Layout":
        """A block of already-paged data (no pack/unpack staging needed)."""
        nbytes = n_pages * page_rows * page_lanes * np.dtype(dtype).itemsize
        return cls(kind="pages", nbytes=nbytes, batch=batch,
                   shape=(n_pages, page_rows, page_lanes),
                   dtype_name=np.dtype(dtype).name)

    @classmethod
    def dense(cls, shape: Sequence[int], dtype, batch: int = 1) -> "Layout":
        shape = tuple(int(s) for s in shape)
        nbytes = math.prod(shape) * np.dtype(dtype).itemsize
        return cls(kind="dense", nbytes=nbytes, batch=batch, shape=shape,
                   dtype_name=np.dtype(dtype).name)

    @classmethod
    def tree(cls, leaves: Sequence[Any]) -> "Layout":
        """An arbitrary list of array leaves (checkpoint staging).  Plain
        Python / numpy scalar leaves (step counters, hyperparameters) are
        sized via numpy, like the host-staging backend stages them."""
        nbytes = 0
        for l in leaves:
            if l is None:
                continue
            if hasattr(l, "shape") and hasattr(l, "dtype"):
                nbytes += int(np.prod(l.shape)) * np.dtype(l.dtype).itemsize
            else:
                nbytes += np.asarray(l).nbytes
        return cls(kind="tree", nbytes=nbytes)


@dataclasses.dataclass(frozen=True)
class Transfer:
    """A bulk-movement request: source/destination tier + layout + policy.

    ``policy`` (a :class:`VillaConfig`) routes compute<->slow transfers
    through the VILLA tier policy (hot-marking, promotion) instead of raw
    page movement.  ``preserve_dtype`` documents the staging contract: paged
    lowering bitcasts to uint8 pages and restores bit-exactly (the only
    supported mode for paged layouts — no silent upcasts on any path).

    ``kind`` defaults to a data-moving transfer; ``kind="fork"`` requests
    the CoW alias lowering instead (repro/fork): same-replica forks lower
    to one ``page_alias`` leg — host bookkeeping priced as a RowClone FPM,
    with the payload recorded as bytes NOT copied — and cross-replica
    forks materialize over the priced migration route.
    """
    src: Tier
    dst: Tier
    layout: Layout
    policy: Optional[VillaConfig] = None
    preserve_dtype: bool = True
    kind: str = "move"


# ---------------------------------------------------------------------------
# Typed legs.  Each leg kind names a registry backend (registry.py); the
# static fields are everything the backend needs beyond traced operands.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Leg:
    """Base leg: ``kind`` selects the backend, ``nbytes`` (per item) and
    ``hops`` drive the pricing, ``batch`` fuses a wave into one dispatch."""
    kind: str = "leg"
    nbytes: int = 0
    hops: int = 0
    batch: int = 1


@dataclasses.dataclass(frozen=True)
class PackLeg(Leg):
    """Bitcast a pytree slot into uint8 pages (zero-cost relabeling)."""
    kind: str = "pack_pages"
    page_spec: Optional[PageSpec] = None


@dataclasses.dataclass(frozen=True)
class UnpackLeg(Leg):
    """Restore uint8 pages into a pytree slot (inverse of PackLeg)."""
    kind: str = "unpack_pages"
    page_spec: Optional[PageSpec] = None


@dataclasses.dataclass(frozen=True)
class PageGatherLeg(Leg):
    """Gather whole pages by a page table (Pallas ``villa_gather``).
    ``pool_key``/``table_key`` name the env operands, so a two-pool plan
    (tier promotion) can bind each leg to its own pool."""
    kind: str = "page_gather"
    pool_key: str = "pool"
    table_key: str = "table"


@dataclasses.dataclass(frozen=True)
class PageScatterLeg(Leg):
    """Scatter whole pages by a page table (Pallas ``villa_scatter``)."""
    kind: str = "page_scatter"
    pool_key: str = "pool"
    table_key: str = "table"


@dataclasses.dataclass(frozen=True)
class TierReadLeg(Leg):
    """VILLA policy-mediated read: promotes hot items to the fast tier."""
    kind: str = "tier_read"
    policy: Optional[VillaConfig] = None


@dataclasses.dataclass(frozen=True)
class TierWriteLeg(Leg):
    """VILLA write-through: slow tier + fast slot if resident."""
    kind: str = "tier_write"
    policy: Optional[VillaConfig] = None


@dataclasses.dataclass(frozen=True)
class TileCopyLeg(Leg):
    """Intra-device bulk copy through VMEM tiles (Pallas ``rbm_copy``)."""
    kind: str = "tile_copy"
    tile_rows: int = 256
    lanes: int = 128


@dataclasses.dataclass(frozen=True)
class HopChainLeg(Leg):
    """Inter-device movement over a mesh axis as a ppermute hop chain.

    ``src``/``dst`` set: point-to-point chain (``rbm.lisa_copy``, ``hops``
    sequential single-pair permutes; ``wraparound`` mirrors the topology so
    the priced route IS the executed route).  Both None: neighbor-shift
    mode (``rbm.rbm_hop`` by ``step`` — the pipeline stage hop), one hop."""
    kind: str = "hop_chain"
    axis: Optional[str] = None
    step: int = 1
    src: Optional[int] = None
    dst: Optional[int] = None
    wraparound: bool = True


@dataclasses.dataclass(frozen=True)
class HostStageLeg(Leg):
    """Cross the off-chip channel: device_get / device_put per leaf."""
    kind: str = "host_stage"
    to_host: bool = True


@dataclasses.dataclass(frozen=True)
class PageAliasLeg(Leg):
    """A zero-copy page alias (fork fast path): the backend is the host
    identity — the ForkPageTable repoints the logical row, no bytes move.
    Priced as a RowClone FPM (``rowclone`` at ``max(hops, 1)``) against the
    memcpy a real per-session copy would have cost; ``nbytes * batch`` is
    the bytes-NOT-copied credit."""
    kind: str = "page_alias"


# ---------------------------------------------------------------------------
# Cost model.
# ---------------------------------------------------------------------------

class MovementCost(NamedTuple):
    """Modeled cost of a plan under both mechanisms (ns / uJ, Table-1
    pricing at system granularity).  ``bytes`` is the true total payload
    (batch included); ``hops`` the largest hop distance any leg crosses."""
    bytes: int
    hops: int
    ns_lisa: float
    ns_memcpy: float
    uj_lisa: float
    uj_memcpy: float

    @property
    def advantage(self) -> float:
        """Modeled memcpy/LISA latency ratio (the Table 1 gap)."""
        return self.ns_memcpy / self.ns_lisa if self.ns_lisa else 1.0

    def scaled(self, k: int) -> "MovementCost":
        return self._replace(bytes=self.bytes * k, ns_lisa=self.ns_lisa * k,
                             ns_memcpy=self.ns_memcpy * k,
                             uj_lisa=self.uj_lisa * k,
                             uj_memcpy=self.uj_memcpy * k)


def retry_cost(cost: MovementCost, retries: int) -> MovementCost:
    """The EXTRA *movement* cost of ``retries`` re-executions of an
    already-charged plan.

    A checksum-failed leg re-issues the whole transfer, so k retries price
    exactly ``cost.scaled(k)`` — cost-additivity the chaos property tests
    pin.  Retry *backoff* is deliberately NOT here: it is mechanism-
    independent waiting, not movement, and folding it into both clocks
    skewed the reported lisa-vs-memcpy ratio with the fault rate (the more
    chaos, the closer the ratio drifted to 1).  Callers charge backoff to
    the virtual clock as its own latency bucket
    (:class:`repro_torch.sched.metrics.Decision.backoff_ns`), keeping
    ``advantage = ns_memcpy / ns_lisa`` fault-rate-invariant."""
    if retries <= 0:
        return MovementCost(0, 0, 0.0, 0.0, 0.0, 0.0)
    return cost.scaled(retries)


class ContendedCost(NamedTuple):
    """A priced movement *and* when it actually ran: ``cost`` is the
    isolated Table-1 bill (unchanged by load), ``start_ns``/``end_ns`` the
    service window a :class:`~repro_torch.core.dram.bank.RequestMultiplexer`
    granted it.  The gap between ``end - ready`` and the isolated service
    time is queue/refresh contention — the load-dependent part of latency
    the bank model adds (DESIGN.md Sec. 15)."""
    cost: MovementCost
    ready_ns: float
    start_ns: float
    end_ns: float

    @property
    def stall_ns(self) -> float:
        """Time spent waiting on bank occupancy or refresh, beyond the
        isolated service time."""
        return self.start_ns - self.ready_ns


def contend(cost: MovementCost, mux, bank: int, ready_ns: float,
            mechanism: str = "lisa") -> ContendedCost:
    """Submit an isolated ``MovementCost`` through a bank multiplexer and
    return it alongside its queued/contended completion window.  The
    active mechanism's ns is the service time; pricing is untouched —
    contention decides *when*, Table 1 decides *how much*."""
    service = cost.ns_lisa if mechanism == "lisa" else cost.ns_memcpy
    start, end = mux.submit(bank, ready_ns, service)
    return ContendedCost(cost=cost, ready_ns=ready_ns, start_ns=start,
                         end_ns=end)


_FREE_LEGS = ("pack_pages", "unpack_pages")      # relabeling, not movement
_CHANNEL_LEGS = ("host_stage",)                  # channel is the only path


def _price_leg(leg: Leg, spec: DramSpec) -> MovementCost:
    if isinstance(leg, PageAliasLeg):
        # Fork fast path: no bytes cross any channel — the lisa arm prices
        # the in-DRAM RowClone alias, the memcpy arm prices the per-session
        # copy the alias avoided.  bytes records what was NOT copied.
        rows = leg.batch * max(1, math.ceil(leg.nbytes / spec.row_bytes))
        h = max(leg.hops, 1)
        return MovementCost(leg.batch * leg.nbytes, leg.hops,
                            rows * spec.copy_latency("rowclone", h),
                            rows * spec.copy_latency("memcpy"),
                            rows * spec.copy_energy("rowclone", h),
                            rows * spec.copy_energy("memcpy"))
    if leg.kind in _FREE_LEGS or leg.nbytes == 0:
        return MovementCost(0, leg.hops, 0.0, 0.0, 0.0, 0.0)
    if isinstance(leg, HopChainLeg):
        if leg.hops == 0:                        # already local: a free move
            return MovementCost(0, 0, 0.0, 0.0, 0.0, 0.0)
        from repro_torch.core.lisa.topology import ici_dram_spec
        spec = ici_dram_spec(leg.nbytes)         # mesh legs: ICI constants
    rows = leg.batch * max(1, math.ceil(leg.nbytes / spec.row_bytes))
    h = max(leg.hops, 1)
    ns_mem = rows * spec.copy_latency("memcpy")
    uj_mem = rows * spec.copy_energy("memcpy")
    if leg.kind in _CHANNEL_LEGS:
        # No in-fabric alternative: both mechanisms pay the channel.
        return MovementCost(leg.batch * leg.nbytes, leg.hops,
                            ns_mem, ns_mem, uj_mem, uj_mem)
    return MovementCost(leg.batch * leg.nbytes, leg.hops,
                        rows * spec.copy_latency("lisa", h), ns_mem,
                        rows * spec.copy_energy("lisa", h), uj_mem)


def _sum_costs(costs: Sequence[MovementCost]) -> MovementCost:
    return MovementCost(
        bytes=sum(c.bytes for c in costs),
        hops=max((c.hops for c in costs), default=0),
        ns_lisa=sum(c.ns_lisa for c in costs),
        ns_memcpy=sum(c.ns_memcpy for c in costs),
        uj_lisa=sum(c.uj_lisa for c in costs),
        uj_memcpy=sum(c.uj_memcpy for c in costs))


def leg_costs(plan: "MovementPlan",
              spec: DramSpec = DDR3_1600) -> Tuple[MovementCost, ...]:
    """Per-leg :class:`MovementCost` breakdown of ``plan`` under ``spec``.

    This re-runs the exact ``_price_leg`` arithmetic that produced
    ``plan.cost`` (same spec, same order), so a left-to-right sum over the
    returned tuple reproduces the plan total bit-for-bit — the contract the
    observability layer's per-leg span attribution relies on.
    """
    return tuple(_price_leg(leg, spec) for leg in plan.legs)


class MovementPlan(NamedTuple):
    """A lowered transfer: typed legs + the priced cost.  Execute with
    :func:`repro_torch.movement.registry.execute`."""
    transfer: Transfer
    legs: Tuple[Leg, ...]
    cost: MovementCost

    def describe(self) -> str:
        t = self.transfer
        legs = " -> ".join(
            f"{l.kind}[{l.batch}x{l.nbytes}B"
            + (f",h={l.hops}" if l.hops else "") + "]" for l in self.legs)
        return (f"{t.src.kind}->{t.dst.kind}: {legs} "
                f"| {self.cost.bytes}B, lisa={self.cost.ns_lisa:.0f}ns, "
                f"memcpy={self.cost.ns_memcpy:.0f}ns "
                f"({self.cost.advantage:.1f}x)")


# ---------------------------------------------------------------------------
# The lowering.
# ---------------------------------------------------------------------------

def plan(transfer: Transfer, spec: DramSpec = DDR3_1600, *,
         topo: Optional["MeshTopology"] = None) -> MovementPlan:
    """Lower a :class:`Transfer` against a spec topology into a typed plan.

    In-device legs are priced by ``spec``'s mechanism registry (hop-chain
    vs channel, the Table 1 model); mesh legs by the ICI analogue
    (:func:`~repro_torch.core.lisa.topology.ici_dram_spec`).  ``topo`` supplies
    hop distances for point-to-point stage transfers.
    """
    src, dst, lay = transfer.src, transfer.dst, transfer.layout
    pair = (src.kind, dst.kind)
    n, b = lay.nbytes, lay.batch
    legs: Tuple[Leg, ...]

    if transfer.kind == "fork":
        # Session fork (repro/fork).  Same replica: ONE page_alias leg —
        # the ForkPageTable repoints the child onto the parent's physical
        # row, zero device dispatches, priced as a RowClone FPM with the
        # per-session copy it avoided on the memcpy arm.  Cross-replica:
        # the alias cannot span slow pools, so the fork MATERIALIZES over
        # the same priced migration route a session move takes.
        if pair != ("slow", "slow"):
            raise ValueError(f"fork transfers alias slow-tier pages "
                             f"(slow->slow); got {pair[0]}->{pair[1]}")
        if transfer.policy is not None:
            raise ValueError("fork transfers are not policy-mediated "
                             "(aliasing never touches the fast tier)")
        if src.index is None or dst.index is None \
                or src.index == dst.index:
            legs = (PageAliasLeg(nbytes=n, batch=b, hops=0),)
        else:
            if src.axis is None or src.axis != dst.axis:
                raise ValueError(
                    "cross-replica forks need matching mesh axis names "
                    f"(got {src.axis!r} -> {dst.axis!r})")
            if topo is None:
                raise ValueError(
                    "cross-replica forks materialize over the migration "
                    "route: pass plan(..., topo=MeshTopology(n_replicas)) "
                    "so the copy is priced over the executed ring")
            legs = (PageGatherLeg(nbytes=0, batch=b, pool_key="src_pool",
                                  table_key="src_table"),
                    HopChainLeg(nbytes=n,
                                hops=topo.hops(src.index, dst.index),
                                batch=b, axis=src.axis, src=src.index,
                                dst=dst.index, wraparound=topo.wraparound),
                    PageScatterLeg(nbytes=0, batch=b, pool_key="dst_pool",
                                   table_key="dst_table"))
        cost = _sum_costs([_price_leg(leg, spec) for leg in legs])
        return MovementPlan(transfer=transfer, legs=legs, cost=cost)

    if transfer.policy and pair not in (("compute", "slow"),
                                        ("slow", "compute")):
        # The VILLA policy itself decides fast-tier placement (hot marking
        # + promotion), and no other tier pair is policy-mediated at all —
        # silently planning a policy-free leg would bypass the TieredStore
        # without any signal to the caller.
        raise ValueError(
            "policy-routed transfers address the slow tier (compute<->slow "
            "with policy=): the policy decides what gets promoted to fast, "
            f"and {pair[0]}->{pair[1]} has no policy-mediated lowering — "
            "drop policy= or retarget the transfer")
    if pair == ("compute", "slow") and transfer.policy:
        # With a PageSpec the payload is a pytree slot staged through uint8
        # pages first; raw paged items go straight to the tier policy.
        pack = (PackLeg(nbytes=0, batch=b, page_spec=lay.page_spec),) \
            if lay.page_spec is not None else ()
        legs = pack + (TierWriteLeg(nbytes=n, hops=1, batch=b,
                                    policy=transfer.policy),)
    elif pair == ("slow", "compute") and transfer.policy:
        unpack = (UnpackLeg(nbytes=0, batch=b, page_spec=lay.page_spec),) \
            if lay.page_spec is not None else ()
        legs = (TierReadLeg(nbytes=n, hops=1, batch=b,
                            policy=transfer.policy),) + unpack
    elif pair in (("compute", "slow"), ("compute", "fast")):
        legs = (PageScatterLeg(nbytes=n, hops=1, batch=b),)
    elif pair in (("slow", "compute"), ("fast", "compute")):
        legs = (PageGatherLeg(nbytes=n, hops=1, batch=b),)
    elif pair in (("slow", "fast"), ("fast", "slow")):
        # Tier promotion / demotion: gather the pages out of the source
        # pool, scatter them into the DESTINATION pool (distinct env keys —
        # binding both legs to one pool would make the move a no-op).  The
        # pair is ONE copy in the cost model (the paper prices a slow<->fast
        # row move once, not per read/write phase): the gather leg carries
        # the payload bytes, the scatter leg is priced free.
        legs = (PageGatherLeg(nbytes=n, hops=1, batch=b,
                              pool_key="src_pool", table_key="src_table"),
                PageScatterLeg(nbytes=0, hops=1, batch=b,
                               pool_key="dst_pool", table_key="dst_table"))
    elif pair == ("slow", "slow"):
        # Cross-replica session migration: the suspended snapshot's pages
        # leave the source replica's slow pool, cross the mesh as a hop
        # chain, and land in the destination replica's slow pool.  The
        # gather/scatter legs are staging (free — the paper prices one row
        # move per migration, not per pool access); the hop-chain leg
        # carries the payload and is priced over the ICI route, so the
        # whole migration is ONE copy under the Table-1 model.
        if src.axis is None or src.axis != dst.axis:
            raise ValueError("cross-replica slow->slow transfers need "
                             "matching mesh axis names (got "
                             f"{src.axis!r} -> {dst.axis!r})")
        if src.index is None or dst.index is None:
            raise ValueError("cross-replica slow->slow transfers name both "
                             "replica indices (src.index / dst.index)")
        if topo is None:
            raise ValueError(
                "cross-replica transfers need the mesh topology: pass "
                "plan(..., topo=MeshTopology(n_replicas)) so the migration "
                "is priced over the same ring the hop chain executes on")
        legs = (PageGatherLeg(nbytes=0, batch=b, pool_key="src_pool",
                              table_key="src_table"),
                HopChainLeg(nbytes=n, hops=topo.hops(src.index, dst.index),
                            batch=b, axis=src.axis, src=src.index,
                            dst=dst.index, wraparound=topo.wraparound),
                PageScatterLeg(nbytes=0, batch=b, pool_key="dst_pool",
                               table_key="dst_table"))
    elif pair == ("device", "host"):
        legs = (HostStageLeg(nbytes=n, batch=b, to_host=True),)
    elif pair == ("host", "device"):
        legs = (HostStageLeg(nbytes=n, batch=b, to_host=False),)
    elif pair == ("stage", "stage"):
        if src.axis is None or src.axis != dst.axis:
            raise ValueError("stage transfer needs matching mesh axis names "
                             f"(got {src.axis!r} -> {dst.axis!r})")
        if src.index is None or dst.index is None:
            legs = (HopChainLeg(nbytes=n, hops=1, batch=b, axis=src.axis),)
        else:
            if topo is None:
                # Guessing the axis size would let the priced hop count
                # diverge from the route lisa_copy actually takes.
                raise ValueError(
                    "point-to-point stage transfers need the mesh topology: "
                    "pass plan(..., topo=MeshTopology(axis_size)) so hops "
                    "are priced over the same ring the chain executes on")
            legs = (HopChainLeg(nbytes=n,
                                hops=topo.hops(src.index, dst.index),
                                batch=b, axis=src.axis,
                                src=src.index, dst=dst.index,
                                wraparound=topo.wraparound),)
    elif pair == ("device", "device"):
        legs = (TileCopyLeg(nbytes=n, hops=1, batch=b),)
    else:
        raise ValueError(f"no lowering for transfer {src.kind!r} -> "
                         f"{dst.kind!r} (layout {lay.kind!r})")

    if lay.kind == "pages" and not transfer.preserve_dtype:
        raise ValueError("paged transfers are dtype-preserving by "
                         "construction; preserve_dtype=False is not a "
                         "supported paged mode")

    cost = _sum_costs([_price_leg(leg, spec) for leg in legs])
    return MovementPlan(transfer=transfer, legs=legs, cost=cost)


def ring_plan(axis: str, axis_size: int, layout: Layout,
              kind: str = "all_gather") -> MovementPlan:
    """A ring collective as a movement plan: one neighbor-shift hop-chain
    leg per ring step ((n-1) for all_gather/reduce_scatter, 2(n-1) for
    all_reduce — the paper's hop chain run twice), each carrying one
    shard's bytes.  Matches ``topology.ring_collective_us`` by
    construction; ``rbm.ring_scan`` is the executing schedule.
    """
    steps = {"all_gather": axis_size - 1,
             "reduce_scatter": axis_size - 1,
             "all_reduce": 2 * (axis_size - 1)}[kind]
    transfer = Transfer(Tier("stage", axis=axis), Tier("stage", axis=axis),
                        layout)
    legs = tuple(HopChainLeg(nbytes=layout.nbytes, hops=1,
                             batch=layout.batch, axis=axis)
                 for _ in range(max(steps, 0)))
    cost = _sum_costs([_price_leg(leg, DDR3_1600) for leg in legs]
                      or [MovementCost(0, 0, 0.0, 0.0, 0.0, 0.0)])
    return MovementPlan(transfer=transfer, legs=legs, cost=cost)


#: Leg kinds whose backends execute a whole wave in one dispatch (scanned
#: policy access / vmapped pack / scanned unpack).  Other kinds would
#: silently move one item while the fused cost reports k — refuse them.
_WAVE_KINDS = frozenset(
    {"pack_pages", "unpack_pages", "tier_read", "tier_write", "page_alias"})


def fuse(plans: Sequence[MovementPlan]) -> MovementPlan:
    """Fuse identical single-item plans into one batched wave (k items, one
    dispatch).  All plans must be equal and every leg wave-capable
    (:data:`_WAVE_KINDS`); cost scales linearly."""
    if not plans:
        raise ValueError("cannot fuse an empty plan list")
    first, k = plans[0], len(plans)
    if any(p != first for p in plans[1:]):
        raise ValueError("fuse() requires identical plans (same transfer, "
                         "legs and spec pricing)")
    unsupported = sorted({l.kind for l in first.legs} - _WAVE_KINDS)
    if unsupported:
        raise ValueError(
            f"fuse() cannot batch {unsupported} legs (their backends run "
            f"one item per dispatch); batch at the caller — e.g. a longer "
            f"page table for gather/scatter — or fuse only policy-staged "
            f"plans (legs in {sorted(_WAVE_KINDS)})")
    if k == 1:
        return first
    lay = dataclasses.replace(first.transfer.layout,
                              batch=first.transfer.layout.batch * k)
    return MovementPlan(
        transfer=dataclasses.replace(first.transfer, layout=lay),
        legs=tuple(dataclasses.replace(l, batch=l.batch * k)
                   for l in first.legs),
        cost=first.cost.scaled(k))
