# Port of src/repro/roofline/attribution.py: the reference attributes bytes
# to HLO op names of the lowered program (it had no device timings); the
# port attributes measured device time to kernels from a torch.profiler
# trace.
"""Device time by kernel from a ``torch.profiler`` trace — the profile the
perf loop reads.

  PYTHONPATH=src python -m repro_torch.roofline.attribution trace.json

The trace is the Chrome trace JSON ``torch.profiler``'s
``export_chrome_trace`` writes.  :func:`attribute` gives:

* the top kernels by device ms, with their launch counts;
* the port's kernels named as the launch counters name them
  (``kernels/ops.py``): ``villa_scatter`` (K1: ``scatter_kernel`` and its
  ``dedupe_kernel``), ``villa_gather`` (K2: ``gather_kernel``),
  ``flash_attention`` (K3: ``prefill_kernel``, ``prefill_short_kernel``,
  ``prefill_wgmma_kernel``, ``decode_split_kernel``),
  ``flash_attention_backward`` (K3e's backward: ``prep_kernel``,
  ``widen_kernel``, ``grads_kernel``),
  ``rbm_copy`` (K4: ``bulk_copy_kernel``);
* the device ms under kernels (``kernel_ms``, the union of the kernel
  events: the time a roofline share divides by) and under copies and
  sets (``copy_ms``: ``gpu_memcpy`` and ``gpu_memset`` events, the
  host<->device copies of a call's inputs and its result among them),
  each a union of its events, and neither counted into the other;
* the device's busy ms (the union of both) and its share of the host
  window (``window_ms`` if given, else the region's span, else the
  trace's span from its first event to its last);
* ``unrecorded``: the launches, copies and sets the host made whose device
  record the trace lacks (0 for a complete trace).

A ``region`` (a ``record_function`` name) scopes all of it to the device
records of the launches made inside that region, matched by CUPTI
correlation id: a trace's device and host clocks disagree (a record can
be stamped before the launch that made it), so time cannot place it.

:func:`capture` is the profile the port's measurements take.  A CUDA
profile loses the first device records of its session: none early in a
process, then more as the process ages (tens late in a run of
``chip_smoke.py``, which prints the count of every profile; enough to
empty a short call's profile).  So the capture launches
:data:`LEAD_IN` one-element kernels, waits for them, and only then enters
the measured region; the records the session drops are the lead-in's.
"""
from __future__ import annotations

import json
import os
import re
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

# the counter name (kernels/ops.py) of each of the port's kernels, by a
# substring of its CUDA symbol
PORT_KERNELS = (("dedupe_kernel", "villa_scatter", "K1"),
                ("scatter_kernel", "villa_scatter", "K1"),
                ("gather_kernel", "villa_gather", "K2"),
                ("prefill_kernel", "flash_attention", "K3"),
                ("prefill_short_kernel", "flash_attention", "K3"),
                ("prefill_wgmma_kernel", "flash_attention", "K3"),
                ("decode_split_kernel", "flash_attention", "K3"),
                ("decode_cluster_kernel", "flash_attention", "K3"),
                ("prep_kernel", "flash_attention_backward", "K3e"),
                ("widen_kernel", "flash_attention_backward", "K3e"),
                ("grads_kernel", "flash_attention_backward", "K3e"),
                ("bulk_copy_kernel", "rbm_copy", "K4"))
KERNEL_CAT = "kernel"
DEVICE_CATS = (KERNEL_CAT, "gpu_memcpy", "gpu_memset")
# the host calls that leave a device record: kernel launches (runtime and
# driver API), copies and sets
HOST_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_CALL = re.compile(r"Launch\w*Kernel|Memcpy|Memset")
REGION = "roofline.region"
LEAD_IN = 1024


def port_kernel(name: str) -> Optional[str]:
    """``"K2 villa_gather"``-style label of a kernel symbol of the port's
    (a name, demangled or bare, whose function is one of
    :data:`PORT_KERNELS`: ``(anonymous namespace)::gather_kernel(...)``,
    not torch's ``vectorized_gather_kernel``), else None."""
    for part, counter, short in PORT_KERNELS:
        if re.search(rf"(^|::|\s){part}\b", name):
            return f"{short} {counter}"
    return None


def _union_us(spans: List[Sequence[float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _spans(events: Sequence[Dict]) -> List[Sequence[float]]:
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
            for e in events]


def _correlation(e: Dict):
    return e.get("args", {}).get("correlation")


def attribute(events: Sequence[Dict], top: int = 20,
              window_ms: Optional[float] = None,
              region: Optional[str] = None) -> Dict[str, object]:
    """Device time by kernel over the trace ``events`` (Chrome trace
    events: ``ph`` "X" with ``ts`` and ``dur`` in us; device ones have
    ``cat`` in :data:`DEVICE_CATS`, the host calls that made them ``cat``
    in :data:`HOST_CATS`, each pair sharing ``args["correlation"]``),
    over the launches made inside the ``region`` annotation if given."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    calls = [e for e in events if e.get("ph") == "X"
             and e.get("cat") in HOST_CATS
             and LAUNCH_CALL.search(e.get("name", ""))]
    timed = [e for e in events if "ts" in e]
    if region is not None:
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and e.get("name") == region]
        if not spans:
            raise ValueError(f"the trace holds no region {region!r}")
        a = float(spans[0]["ts"])
        b = a + float(spans[0].get("dur", 0.0))
        calls = [e for e in calls if a <= float(e["ts"]) <= b]
        made = {_correlation(e) for e in calls}
        dev = [e for e in dev if _correlation(e) in made]
        timed = [spans[0]]
    recorded = {_correlation(e) for e in dev}
    unrecorded = sum(_correlation(e) not in recorded for e in calls)
    kernels = [e for e in dev if e["cat"] == KERNEL_CAT]
    copies = [e for e in dev if e["cat"] != KERNEL_CAT]
    by: Dict[str, List] = {}
    for e in dev:
        rec = by.setdefault(e["name"], [0.0, 0, e["cat"] == KERNEL_CAT])
        rec[0] += float(e.get("dur", 0.0))
        rec[1] += 1
    busy_us = _union_us(_spans(dev))
    if window_ms is None:
        if timed:
            start = min(float(e["ts"]) for e in timed)
            stop = max(float(e["ts"]) + float(e.get("dur", 0.0))
                       for e in timed)
            window_ms = (stop - start) / 1e3
        else:
            window_ms = 0.0
    rows = sorted(({"name": n, "device_ms": us / 1e3, "count": c,
                    "kind": "kernel" if is_kernel else "copy",
                    "port": port_kernel(n)}
                   for n, (us, c, is_kernel) in by.items()),
                  key=lambda r: -r["device_ms"])
    top_kernels = [r for r in rows if r["kind"] == "kernel"]
    ports: Dict[str, Dict[str, float]] = {}
    for r in rows:
        if r["port"]:
            p = ports.setdefault(r["port"], {"device_ms": 0.0, "count": 0})
            p["device_ms"] += r["device_ms"]
            p["count"] += r["count"]
    return {
        "kernels": rows[:top],
        "port_kernels": ports,
        "launches": len(kernels),
        "copies": len(copies),
        "unrecorded": unrecorded,
        "kernel_ms": _union_us(_spans(kernels)) / 1e3,
        "copy_ms": _union_us(_spans(copies)) / 1e3,
        "busy_ms": busy_us / 1e3,
        "window_ms": window_ms,
        "busy_share": (busy_us / 1e3 / window_ms) if window_ms else 0.0,
        "dominant": top_kernels[0]["name"] if top_kernels else None,
    }


def load(path: str) -> List[Dict]:
    """The events of a Chrome trace JSON file (an object with
    ``traceEvents``, or a bare list)."""
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def from_profiler(prof) -> List[Dict]:
    """The events of a finished ``torch.profiler.profile``, through its
    Chrome trace export (a temporary file, removed after)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return load(path)
    finally:
        os.remove(path)


def capture(fn, *, top: int = 20, **kw):
    """``fn()`` once under ``torch.profiler`` (CPU and CUDA) inside the
    :data:`REGION` annotation, after :data:`LEAD_IN` one-element kernels
    and with the card synchronised before the region and at its end: (the
    profile, :func:`attribute` of the region over the host window of the
    call and its sync).  The attribution's ``lead_in_unrecorded`` counts
    the device records the session dropped before the region.  ``kw``
    goes to ``torch.profiler.profile``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    pad = torch.zeros(1, device=torch.device("cuda",
                                             torch.cuda.current_device()))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **kw) as prof:
        for _ in range(LEAD_IN):
            pad.add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function(REGION):
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = from_profiler(prof)
    att = attribute(events, top=top, window_ms=wall_ms, region=REGION)
    att["lead_in_unrecorded"] = (attribute(events, top=0)["unrecorded"]
                                 - att["unrecorded"])
    return prof, att


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) != 1:
        print("usage: python -m repro_torch.roofline.attribution trace.json",
              file=sys.stderr)
        return 2
    got = attribute(load(args[0]))
    print(f"device busy {got['busy_ms']:.3f} ms of a {got['window_ms']:.3f} "
          f"ms window ({100 * got['busy_share']:.1f}%): kernels "
          f"{got['kernel_ms']:.3f} ms ({got['launches']} launches), copies "
          f"and sets {got['copy_ms']:.3f} ms ({got['copies']}); "
          f"{got['unrecorded']} launches without a device record")
    for r in got["kernels"]:
        tag = f" [{r['port']}]" if r["port"] else ""
        print(f"{r['device_ms']:10.4f} ms {r['count']:6d}x  "
              f"{r['name'][:100]}{tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
