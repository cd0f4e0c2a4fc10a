# Port of src/repro/core/dram/traces.py in torch.  ``TraceConfig`` is the
# reference's dataclass; ``generate`` follows ``_generate_traced`` (:70-107)
# draw for draw with torch's samplers on a CPU generator, so the same seed
# gives the same trace on the CPU and on the card.  ``jax.random``'s draws
# cannot be reproduced: ``trace_from_numpy`` takes the reference's traces.
"""Synthetic multi-core memory traces for the controller simulator.

The paper evaluates 50 four-core workloads built from SPEC/TPC traces (via
Pin + Ramulator).  Those traces are not redistributable, so the system-level
benchmarks here use parameterised synthetic traces with the two properties
the paper's results hinge on:

  * a Zipf-like hot-row access distribution (drives VILLA hit rate), and
  * a configurable fraction of bulk-copy operations (drives RISC gains).

Bank geometry (subarray count, rows per subarray) comes from the
:class:`~repro_torch.core.dram.spec.DramSpec` passed to :func:`generate`;
:class:`TraceConfig` holds only the *workload* knobs.  Every draw is made
on a CPU ``torch.Generator`` and the finished trace is moved to ``device``
(default: cuda, raising without a GPU).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import resolve_device, to_device
from repro_torch.core.dram.spec import DDR3_1600, DramSpec


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    n_requests: int = 8192
    n_cores: int = 4
    n_banks: int = 8
    copy_prob: float = 0.005         # fraction of requests that are bulk copies
    zipf_s: float = 1.4              # hot-row skew
    hot_rows: int = 64               # size of the hot set per bank
    mean_gap_ns: float = 100.0       # mean inter-arrival time


class Trace(NamedTuple):
    t: torch.Tensor         # (N,) float32 arrival times, sorted
    core: torch.Tensor      # (N,) int32
    bank: torch.Tensor      # (N,) int32
    row: torch.Tensor       # (N,) int32 global row id within bank (sa*rows + r)
    is_copy: torch.Tensor   # (N,) bool
    dst_row: torch.Tensor   # (N,) int32 copy destination row id


def generate(generator: torch.Generator, cfg: TraceConfig,
             spec: DramSpec = DDR3_1600, device=None) -> Trace:
    """One trace drawn from ``generator`` (a CPU generator), on
    ``device``."""
    return _moved(_draw(generator, cfg.copy_prob, cfg.zipf_s, cfg, spec),
                  resolve_device(device))


def generate_batch(generators: Sequence[torch.Generator], copy_probs,
                   zipf_ss, cfg: TraceConfig, spec: DramSpec = DDR3_1600,
                   device=None) -> Trace:
    """A whole workload sweep: ``generators`` / ``copy_probs`` / ``zipf_ss``
    share a leading workload axis.  The result is a stacked :class:`Trace`
    ready for ``controller.simulate_sweep``."""
    traces = [_draw(g, float(p), float(z), cfg, spec)
              for g, p, z in zip(generators, copy_probs, zipf_ss)]
    return _moved(Trace(*(torch.stack(xs) for xs in zip(*traces))),
                  resolve_device(device))


def trace_from_numpy(trace, device=None) -> Trace:
    """A trace whose fields are numpy arrays (the reference's ``Trace``
    through ``np.asarray``, stacked or not) as a :class:`Trace` on
    ``device``."""
    dtypes = (torch.float32, torch.int32, torch.int32, torch.int32,
              torch.bool, torch.int32)
    return Trace(*(to_device(np.asarray(getattr(trace, f)),
                             resolve_device(device), dt)
                   for f, dt in zip(Trace._fields, dtypes)))


def _moved(tr: Trace, device: torch.device) -> Trace:
    return Trace(*(to_device(x, device) for x in tr))


def _draw(g: torch.Generator, copy_prob: float, zipf_s: float,
          cfg: TraceConfig, spec: DramSpec) -> Trace:
    """The reference's ``_generate_traced`` with torch's samplers, in its
    order of draws, on the CPU."""
    n = cfg.n_requests
    rows_per_sa = spec.rows_per_subarray
    n_rows = spec.n_rows

    def randint(lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, dtype=torch.int32)

    def uniform():
        return torch.rand((n,), generator=g, dtype=torch.float32)

    gaps = torch.empty(n, dtype=torch.float32).exponential_(
        generator=g) * cfg.mean_gap_ns
    t = torch.cumsum(gaps, 0).to(torch.float32)

    core = randint(0, cfg.n_cores)
    bank = randint(0, cfg.n_banks)

    # Zipf over a hot set + uniform tail.  Hot set lives in the *slow*
    # subarrays (sa >= 1); subarray 0 is the fast (VILLA) subarray.
    ranks = torch.arange(1, cfg.hot_rows + 1, dtype=torch.float32)
    p = ranks ** (-torch.tensor(zipf_s, dtype=torch.float32))
    p = p / p.sum()
    # inverse-CDF categorical draw (left side, as jnp.searchsorted)
    u = uniform()
    hot_pick = torch.searchsorted(torch.cumsum(p, 0), u).to(torch.int32)
    hot_pick = torch.clamp(hot_pick, max=cfg.hot_rows - 1)
    hot_rows = rows_per_sa + hot_pick                    # rows in subarray 1+
    uniform_rows = randint(rows_per_sa, n_rows)
    take_hot = uniform() < 0.8
    row = torch.where(take_hot, hot_rows, uniform_rows).to(torch.int32)

    is_copy = uniform() < copy_prob
    dst_row = randint(rows_per_sa, n_rows)
    # ensure copy src/dst land in different subarrays: wrap, then raise
    # out of the fast subarray, in the reference's order
    same_sa = (dst_row // rows_per_sa) == (row // rows_per_sa)
    dst_row = torch.where(same_sa, (dst_row + rows_per_sa) % n_rows, dst_row)
    dst_row = torch.clamp(dst_row, min=rows_per_sa).to(torch.int32)
    return Trace(t=t, core=core, bank=bank, row=row, is_copy=is_copy,
                 dst_row=dst_row)
