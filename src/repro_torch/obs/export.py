# Port of src/repro/obs/export.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""Chrome-trace (``trace_events``) export of a :class:`~repro_torch.obs.Tracer`.

The output is the JSON-object flavor Perfetto / ``chrome://tracing``
accept: ``{"traceEvents": [...], "displayTimeUnit": "ns"}`` with ``ph:"X"``
complete events (``ts``/``dur`` in microseconds — the format's unit) and
``ph:"i"`` instants.  Modeled ns live unrounded in each event's ``args``
(``ns`` plus the lisa/memcpy cost split), so the trace stays exact even
though the viewer renders microseconds.

Byte stability is a contract: events are emitted in span-recording order
(deterministic under a fixed seed), keys are sorted, separators are
compact, and ``allow_nan=False`` keeps the artifact strict JSON — two
same-seed runs produce byte-identical files (``tests/test_obs.py`` pins
this).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

from repro_torch.obs.tracer import Tracer

__all__ = ["trace_events", "chrome_trace", "write_chrome_trace"]

#: pid for the whole modeled timeline (one "process": the virtual clock).
_PID = 0

_LANE0 = "scheduler"


def _lane_name(lane: int, n_lanes: int) -> str:
    if lane == 0:
        return _LANE0
    return f"replica-{lane - 1}"


def trace_events(tracer: Tracer) -> List[Dict[str, Any]]:
    """The ``traceEvents`` list: metadata rows naming each lane, then one
    event per span in recording order."""
    lanes = sorted({s.lane for s in tracer.spans})
    evs: List[Dict[str, Any]] = []
    for lane in lanes:
        evs.append({"ph": "M", "pid": _PID, "tid": lane,
                    "name": "thread_name",
                    "args": {"name": _lane_name(lane, len(lanes))}})
    for s in tracer.spans:
        args = dict(s.attrs)
        args["ns"] = s.ns
        ev: Dict[str, Any] = {
            "name": s.name, "cat": s.cat or "span",
            "pid": _PID, "tid": s.lane,
            "ts": s.t0_ns / 1e3, "args": args,
        }
        if s.instant:
            ev["ph"] = "i"
            ev["s"] = "t"
        else:
            ev["ph"] = "X"
            ev["dur"] = s.ns / 1e3
        evs.append(ev)
    return evs


def chrome_trace(tracer: Tracer) -> str:
    """The full trace as a strict-JSON string (byte-stable per docstring)."""
    payload = {"traceEvents": trace_events(tracer),
               "displayTimeUnit": "ns",
               "otherData": {"clock": "modeled-virtual-ns",
                             "mechanism": tracer.mechanism}}
    return json.dumps(payload, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)


def write_chrome_trace(tracer: Tracer, path: str) -> str:
    """Write the trace to ``path``; returns the path."""
    with open(path, "w") as f:
        f.write(chrome_trace(tracer))
        f.write("\n")
    return path
