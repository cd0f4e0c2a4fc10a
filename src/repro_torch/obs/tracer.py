# Port of src/repro/obs/tracer.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""Virtual-clock span tracing: one observable timeline for the substrate.

Every nanosecond the scheduler's virtual clock charges comes from somewhere
— a decode dispatch, a movement-plan leg, a fault retry's backoff, a
recovery restore.  The :class:`Tracer` records that attribution as spans in
MODELED ns (the same numbers the :class:`~repro_torch.sched.metrics.Decision`
ledger charges), laid out on per-replica lanes, with parent/child nesting
inside each lane.  It is pure host bookkeeping: no device syncs, no
``time.time`` (repro-lint's wallclock rule covers this package), zero
device dispatches (pinned by ``tests/test_obs.py``).

Timeline model
--------------
  * lane 0              — the scheduler lane (tick / decode / prefill and,
                          for the single-engine scheduler, movement waves);
  * lane 1 + r          — replica ``r``'s movement lane (cluster waves run
                          per-replica; the clock advances by the slowest
                          lane, exactly what the spans show);
  * last lane           — the write-behind lane (snapshot waves: priced,
                          never clock-charged).

Each lane keeps a monotone cursor in modeled ns.  ``emit`` places a
complete span at the cursor and advances it; ``begin_span``/``end_span``
bracket children (the repro-lint ``unclosed-span`` rule checks every
``begin_span`` has a matching ``end_span`` in the same function — or use
the :meth:`Tracer.span` context manager).  Parentage is per lane: a span
begun while another is open on the same lane becomes its child.

Movement spans carry the full lisa-vs-memcpy :class:`MovementCost` split in
their attrs; per-leg child spans partition the per-move totals exactly
(last leg residual-corrected), so summing leg attrs in emission order
reproduces the Decision ledger bit-for-bit — the additivity contract
``tests/test_obs.py`` pins.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = ["Span", "Tracer", "NullTracer", "NULL_TRACER"]

#: Attr value types that survive strict-JSON export unchanged.
_JSONABLE = (str, int, float, bool, type(None))


class Span:
    """One interval (or instant) on a lane, in modeled ns."""

    __slots__ = ("name", "cat", "lane", "t0_ns", "t1_ns", "parent",
                 "attrs", "index", "instant")

    def __init__(self, name: str, cat: str, lane: int, t0_ns: float,
                 parent: Optional["Span"], index: int,
                 instant: bool = False):
        self.name = name
        self.cat = cat
        self.lane = lane
        self.t0_ns = float(t0_ns)
        self.t1_ns = float(t0_ns)
        self.parent = parent
        self.attrs: Dict[str, Any] = {}
        self.index = index
        self.instant = instant

    @property
    def ns(self) -> float:
        return self.t1_ns - self.t0_ns

    def __repr__(self) -> str:                   # pragma: no cover - debug
        return (f"Span({self.name!r}, lane={self.lane}, "
                f"t0={self.t0_ns:.0f}, ns={self.ns:.0f})")


class Tracer:
    """Span recorder over the virtual clock (see module docstring).

    ``mechanism`` names which cost arm ("lisa" | "memcpy") drives span
    DURATIONS — matching the scheduler's charging mechanism — while attrs
    always carry both arms.  All state is plain host Python: recording a
    span never touches a device.
    """

    enabled = True

    def __init__(self, mechanism: str = "lisa"):
        if mechanism not in ("lisa", "memcpy"):
            raise ValueError(f"unknown mechanism {mechanism!r} "
                             "(known: lisa, memcpy)")
        self.mechanism = mechanism
        self.spans: List[Span] = []
        self._stacks: Dict[int, List[Span]] = {}
        self._cursor: Dict[int, float] = {}
        self._attribution: Dict[str, Dict[str, Any]] = {}

    # ---- clock cursors -----------------------------------------------------

    def now(self, lane: int = 0) -> float:
        """The lane's cursor: where the next span on it starts."""
        return self._cursor.get(lane, 0.0)

    def seek(self, lane: int, t_ns: float) -> None:
        """Advance the lane cursor to ``t_ns`` (monotone: never rewinds).
        Seeking also registers the lane, so :meth:`seek_all` covers it."""
        cur = self._cursor.get(lane)
        if cur is None or t_ns > cur:
            self._cursor[lane] = float(t_ns)

    def seek_all(self, t_ns: float) -> None:
        """Advance every known lane cursor to ``t_ns`` (tick barrier)."""
        for lane in self._cursor:
            if t_ns > self._cursor[lane]:
                self._cursor[lane] = float(t_ns)

    # ---- span recording ----------------------------------------------------

    def _clean_attrs(self, attrs: Optional[Dict[str, Any]]) -> \
            Dict[str, Any]:
        if not attrs:
            return {}
        return {k: (v if isinstance(v, _JSONABLE) else str(v))
                for k, v in attrs.items()}

    def begin_span(self, name: str, lane: int = 0, cat: str = "phase",
                   attrs: Optional[Dict[str, Any]] = None,
                   t0_ns: Optional[float] = None) -> Span:
        """Open a span at the lane cursor (or explicit ``t0_ns``).  MUST be
        paired with :meth:`end_span` in the same function (repro-lint
        ``unclosed-span``), or use :meth:`span`."""
        t0 = self.now(lane) if t0_ns is None else float(t0_ns)
        self.seek(lane, t0)
        stack = self._stacks.setdefault(lane, [])
        parent = stack[-1] if stack else None
        s = Span(name, cat, lane, t0, parent, len(self.spans))
        s.attrs.update(self._clean_attrs(attrs))
        extra = self._attribution.get(name)
        if extra:
            s.attrs.update(self._clean_attrs(extra))
        self.spans.append(s)
        stack.append(s)
        return s

    def end_span(self, span: Span, t1_ns: Optional[float] = None,
                 attrs: Optional[Dict[str, Any]] = None) -> Span:
        """Close ``span``.  ``t1_ns`` defaults to the lane cursor (i.e. the
        span covers everything emitted inside it); the cursor advances to
        the close time."""
        stack = self._stacks.get(span.lane, [])
        if not stack or stack[-1] is not span:
            raise RuntimeError(
                f"end_span({span.name!r}): span is not the innermost open "
                f"span on lane {span.lane} — close children first")
        stack.pop()
        t1 = self.now(span.lane) if t1_ns is None else float(t1_ns)
        if t1 < span.t0_ns:
            raise RuntimeError(f"end_span({span.name!r}): t1 {t1} precedes "
                               f"t0 {span.t0_ns} (modeled time is monotone)")
        span.t1_ns = t1
        span.attrs.update(self._clean_attrs(attrs))
        self.seek(span.lane, t1)
        return span

    @contextlib.contextmanager
    def span(self, name: str, lane: int = 0, cat: str = "phase",
             attrs: Optional[Dict[str, Any]] = None,
             t0_ns: Optional[float] = None) -> Iterator[Span]:
        """Context-managed begin/end pair (always balanced)."""
        s = self.begin_span(name, lane=lane, cat=cat, attrs=attrs,
                            t0_ns=t0_ns)
        try:
            yield s
        finally:
            self.end_span(s)

    def emit(self, name: str, ns: float, lane: int = 0, cat: str = "phase",
             attrs: Optional[Dict[str, Any]] = None) -> Span:
        """A complete leaf span of duration ``ns`` at the lane cursor; the
        cursor advances past it (sequential within the lane)."""
        s = self.begin_span(name, lane=lane, cat=cat, attrs=attrs)
        self.end_span(s, t1_ns=s.t0_ns + float(ns))
        return s

    def instant(self, name: str, lane: int = 0, cat: str = "event",
                attrs: Optional[Dict[str, Any]] = None,
                t_ns: Optional[float] = None) -> Span:
        """A zero-duration event mark (fork / CoW break / eviction /
        fault incident) at the lane cursor."""
        t0 = self.now(lane) if t_ns is None else float(t_ns)
        stack = self._stacks.get(lane, [])
        s = Span(name, cat, lane, t0, stack[-1] if stack else None,
                 len(self.spans), instant=True)
        s.attrs.update(self._clean_attrs(attrs))
        self.spans.append(s)
        return s

    # ---- movement attribution ---------------------------------------------

    def move_span(self, wave_kind: str, lane: int,
                  totals: Sequence[float],
                  leg_items: Sequence[Tuple[str, Sequence[float],
                                            Dict[str, Any]]],
                  attrs: Optional[Dict[str, Any]] = None) -> Span:
        """One priced movement (a wave member) and its per-leg children.

        ``totals`` is the 4-tuple ``(ns_lisa, ns_memcpy, uj_lisa,
        uj_memcpy)`` the Decision ledger charges for this move.  Each item
        of ``leg_items`` is ``(leg_kind, (ns_l, ns_m, uj_l, uj_m), extra)``
        — already scaled to this move.  The LAST leg is residual-corrected
        against ``totals`` so a left-to-right sum over the emitted leg
        attrs reproduces ``totals`` exactly (every current plan carries its
        cost on one leg, which makes the residual exact, not approximate).
        """
        mech = 0 if self.mechanism == "lisa" else 1
        base = {"ns_lisa": totals[0], "ns_memcpy": totals[1],
                "uj_lisa": totals[2], "uj_memcpy": totals[3],
                "wave": wave_kind}
        if attrs:
            base.update(attrs)
        mv = self.begin_span("move", lane=lane, cat="move", attrs=base)
        acc = [0.0, 0.0, 0.0, 0.0]
        last = len(leg_items) - 1
        for i, (kind, vals, extra) in enumerate(leg_items):
            if i == last:
                vals = tuple(totals[j] - acc[j] for j in range(4))
            else:
                for j in range(4):
                    acc[j] += vals[j]
            leg_attrs = {"ns_lisa": vals[0], "ns_memcpy": vals[1],
                         "uj_lisa": vals[2], "uj_memcpy": vals[3],
                         "wave": wave_kind}
            leg_attrs.update(extra)
            self.emit(kind, vals[mech], lane=lane, cat="leg",
                      attrs=leg_attrs)
        self.end_span(mv)
        return mv

    # ---- roofline binding --------------------------------------------------

    def bind_attribution(self, mapping: Dict[str, Dict[str, Any]]) -> None:
        """Attach roofline attribution to span names: every subsequent span
        named ``k`` gains ``mapping[k]``'s entries as attrs (e.g. decode
        spans gain the dominant HLO kernel + its byte/flop share), so the
        trace answers "which kernel owns this tick's time"."""
        for name, extra in mapping.items():
            self._attribution[name] = dict(extra)

    # ---- aggregation -------------------------------------------------------

    def rollup(self) -> Dict[str, Any]:
        """Aggregated per-phase / per-leg totals (merged into
        ``Metrics.summary()``).  Keys sorted for stable artifacts."""
        per_phase: Dict[str, Dict[str, Any]] = {}
        legs: Dict[str, Dict[str, Any]] = {}
        for s in self.spans:
            key = s.cat or s.name
            d = per_phase.setdefault(key, {"count": 0, "ns": 0.0})
            d["count"] += 1
            d["ns"] += s.ns
            if s.cat == "leg":
                l = legs.setdefault(
                    s.name, {"count": 0, "ns_lisa": 0.0, "ns_memcpy": 0.0})
                l["count"] += 1
                l["ns_lisa"] += float(s.attrs.get("ns_lisa", 0.0))
                l["ns_memcpy"] += float(s.attrs.get("ns_memcpy", 0.0))
        return {
            "spans": len(self.spans),
            "per_phase": {k: {"count": v["count"], "ns": round(v["ns"], 2)}
                          for k, v in sorted(per_phase.items())},
            "legs": {k: {"count": v["count"],
                         "ns_lisa": round(v["ns_lisa"], 2),
                         "ns_memcpy": round(v["ns_memcpy"], 2)}
                     for k, v in sorted(legs.items())},
        }

    def top_spans(self, n: int = 5) -> List[Dict[str, Any]]:
        """The ``n`` longest non-instant spans by modeled ns (stable
        tie-break by emission index)."""
        ranked = sorted((s for s in self.spans if not s.instant),
                        key=lambda s: (-s.ns, s.index))
        return [{"name": s.name, "cat": s.cat, "lane": s.lane,
                 "t0_ns": round(s.t0_ns, 2), "ns": round(s.ns, 2)}
                for s in ranked[:n]]


class NullTracer:
    """Disabled tracer: every call is a cheap no-op so instrumented code
    reads straight-line (no ``if tracer`` guards at call sites)."""

    enabled = False
    mechanism = "lisa"
    spans: List[Span] = []

    _SPAN = Span("null", "", 0, 0.0, None, -1)

    def now(self, lane: int = 0) -> float:
        return 0.0

    def seek(self, lane: int, t_ns: float) -> None:
        pass

    def seek_all(self, t_ns: float) -> None:
        pass

    def begin_span(self, name: str, lane: int = 0, cat: str = "phase",
                   attrs: Optional[Dict[str, Any]] = None,
                   t0_ns: Optional[float] = None) -> Span:
        return self._SPAN

    def end_span(self, span: Span, t1_ns: Optional[float] = None,
                 attrs: Optional[Dict[str, Any]] = None) -> Span:
        return self._SPAN

    @contextlib.contextmanager
    def span(self, name: str, lane: int = 0, cat: str = "phase",
             attrs: Optional[Dict[str, Any]] = None,
             t0_ns: Optional[float] = None) -> Iterator[Span]:
        yield self._SPAN

    def emit(self, name: str, ns: float, lane: int = 0, cat: str = "phase",
             attrs: Optional[Dict[str, Any]] = None) -> Span:
        return self._SPAN

    def instant(self, name: str, lane: int = 0, cat: str = "event",
                attrs: Optional[Dict[str, Any]] = None,
                t_ns: Optional[float] = None) -> Span:
        return self._SPAN

    def move_span(self, wave_kind: str, lane: int,
                  totals: Sequence[float],
                  leg_items: Sequence[Tuple[str, Sequence[float],
                                            Dict[str, Any]]],
                  attrs: Optional[Dict[str, Any]] = None) -> Span:
        return self._SPAN

    def bind_attribution(self, mapping: Dict[str, Dict[str, Any]]) -> None:
        pass

    def rollup(self) -> Dict[str, Any]:
        return {"spans": 0, "per_phase": {}, "legs": {}}

    def top_spans(self, n: int = 5) -> List[Dict[str, Any]]:
        return []


#: Shared disabled tracer: ``self.trace = tracer or NULL_TRACER``.
NULL_TRACER = NullTracer()
