# Port of src/repro/obs/__init__.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""One observable timeline: virtual-clock span tracing + attribution.

Public surface::

    from repro_torch import obs

    tr = obs.Tracer(mechanism="lisa")
    s = Scheduler(engine, cfg, tracer=tr)   # spans in modeled ns
    s.run()                                  # summary() gains a trace block
    obs.write_chrome_trace(tr, "trace.json") # open in Perfetto

Spans record the SAME numbers the Decision ledger charges (per-leg
movement splits, fault retries, recovery restores), on per-replica lanes —
see DESIGN.md Sec. 14 for the span <-> DRAM-command-timeline mapping and
:mod:`repro_torch.obs.tracer` for the lane/cursor model.  Everything here is
host bookkeeping over the virtual clock: zero device dispatches, no
wall-clock reads (repro-lint enforced).
"""
from repro_torch.obs.tracer import NULL_TRACER, NullTracer, Span, Tracer
from repro_torch.obs.export import chrome_trace, trace_events, write_chrome_trace

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "Span",
    "chrome_trace", "trace_events", "write_chrome_trace",
]
