# Port of src/repro/analysis/testlib.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""Shared dispatch/compile-count asserters for tests, benchmarks and CI.

PRs 2–5 pinned the one-dispatch-per-wave and compile-once invariants as
ad-hoc expressions (``eng.compile_counts()["decode"] in (1, -1)``) scattered
across test files; this module is the ONE checker both the test suite and
the ``repro-lint`` CI gate call, so the tolerance for the ``-1``
probe-unavailable sentinel (jax builds without ``_cache_size``) lives in
exactly one place.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Union

UNKNOWN = -1      # compile_counts() sentinel: no jit cache-size probe


def _counts(obj) -> Mapping[str, int]:
    """Accept an Engine/Cluster (anything with ``compile_counts()``) or a
    plain counts mapping."""
    if hasattr(obj, "compile_counts"):
        return obj.compile_counts()
    return obj


def _flatten(allowed) -> set:
    flat = set()
    for a in allowed:
        if isinstance(a, int):
            flat.add(a)
        else:
            flat.update(a)
    return flat


def compile_count_ok(count: int, *allowed: Union[int, Iterable[int]]) -> bool:
    """True when ``count`` is one of ``allowed`` — or the probe-unavailable
    sentinel, which asserters must treat as 'unknown', never as a
    regression."""
    return count == UNKNOWN or count in _flatten(allowed)


def assert_compile_count(obj, key: str, *allowed) -> None:
    """The hot path ``key`` compiled an allowed number of times (decode: 1;
    a wave entry: one per wave width seen; an unused single-item path: 0)."""
    counts = _counts(obj)
    count = counts[key]
    if not compile_count_ok(count, *allowed):
        raise AssertionError(
            f"{key} compiled {count}x, expected one of "
            f"{sorted(_flatten(allowed))} (full counts: {dict(counts)})")


def assert_compile_at_most(obj, key: str, bound: int) -> None:
    counts = _counts(obj)
    count = counts[key]
    if count != UNKNOWN and count > bound:
        raise AssertionError(f"{key} compiled {count}x > bound {bound} "
                             f"(full counts: {dict(counts)})")


def assert_dispatch_delta(stats_before: Mapping[str, int],
                          stats_after: Mapping[str, int], *,
                          decode: int = None, host: int = None) -> None:
    """The paper's step invariant as a delta check: over the measured
    window, exactly ``decode`` fused dispatches and ``host`` device→host
    transfers happened (one each per step, however ragged the batch)."""
    if decode is not None:
        got = stats_after["decode_dispatches"] - stats_before[
            "decode_dispatches"]
        if got != decode:
            raise AssertionError(
                f"{got} decode dispatches over the window, expected "
                f"{decode} (one fused dispatch per step)")
    if host is not None:
        got = stats_after["host_transfers"] - stats_before["host_transfers"]
        if got != host:
            raise AssertionError(
                f"{got} host transfers over the window, expected {host} "
                f"(one device->host sync per step)")


def snapshot_stats(engine) -> Dict[str, int]:
    """Copy the dispatch counters before a measured window."""
    return dict(engine.stats)
