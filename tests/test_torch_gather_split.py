"""K2's work split (``csrc/page_copy.cu``'s gather), held on the CPU.

The kernel cannot run here.  ``rbm_copy.gather_copies`` repeats its index
math: units of at most 8 KiB of a page, batches of 32 units a warp (one
table load a lane, a ballot of the live entries), the live units through
a warp's two 16 KiB halves one a lane, warps numbered CTA-fastest over a
persistent grid.  Over tables that
are all live, all -1, one live run of 1/8 at any offset, and random, and
over pages of 16 B to 64 KiB and grids shorter than the table, it must
copy every vector of every live entry exactly once, from the right source,
and nothing else; a run of live entries must spread over the warps.
"""
from collections import Counter

import numpy as np
import pytest

from repro_torch.kernels import rbm_copy as RC

PAGES = (16, 48, 1024, 4096, 4112, 8208, 65536)
KINDS = ("all", "dead", "run_start", "run_mid", "run_end", "random")
GRID = 2                            # CTAs: 12 warps, fewer than the batches


def _table(kind, n, n_pool, seed):
    rng = np.random.default_rng(seed)
    live = rng.integers(0, n_pool, n)
    if kind == "all":
        return live
    if kind == "dead":
        return np.full(n, -1)
    if kind == "random":
        return np.where(rng.random(n) < 0.5, live,
                        rng.choice([-1, n_pool, n_pool + 7], n))
    run = max(1, n // 8)
    start = {"run_start": 0, "run_mid": (n - run) * 3 // 7,
             "run_end": n - run}[kind]
    out = np.full(n, -1)
    out[start:start + run] = live[start:start + run]
    return out


def _n(page_bytes):
    return 24 if page_bytes > 4112 else 300


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("page_bytes", PAGES)
def test_gather_split_copies_every_live_vector_once(page_bytes, kind):
    n, n_pool = _n(page_bytes), 97
    table = _table(kind, n, n_pool, page_bytes + len(kind))
    copies = RC.gather_copies(table, n_pool, page_bytes, GRID)
    pv = page_bytes // 16
    want = {j * pv + i: int(table[j]) * pv + i for j in range(n)
            if 0 <= table[j] < n_pool for i in range(pv)}
    dst = Counter(d for _, _, d in copies)
    assert all(c == 1 for c in dst.values())
    assert {d: s for _, s, d in copies} == want


@pytest.mark.parametrize("page_bytes", (1024, 65536))
def test_gather_split_spreads_a_live_run_over_the_warps(page_bytes):
    """One live run of 1/8 of a long table (a one-pair hop's shape): the
    live batches go to distinct warps while there are more warps than
    batches, so no warp copies more than its share."""
    n_pool = 97
    n = 8 * 32 * 16 if page_bytes == 1024 else 8 * 16 * 4
    table = _table("run_mid", n, n_pool, 3)
    grid = 64                                    # 384 warps
    plan = RC.gather_plan(n, page_bytes, grid)
    copies = RC.gather_copies(table, n_pool, page_bytes, grid)
    per_warp = Counter(w for w, _, _ in copies)
    live_batches = -(-int((table >= 0).sum()) * plan.spp // 32)
    assert live_batches <= plan.blocks * RC.GATHER_WARPS
    assert len(per_warp) >= live_batches
    assert max(per_warp.values()) <= 32 * plan.unit_vecs


@pytest.mark.parametrize("page_bytes,unit,spp,per_half", [
    (16, 1, 1, 32), (48, 3, 1, 32), (512, 32, 1, 32), (1024, 64, 1, 16),
    (4096, 256, 1, 4), (4112, 257, 1, 3), (8192, 512, 1, 2),
    (8208, 512, 2, 2), (65536, 512, 8, 2)])
def test_gather_plan_units(page_bytes, unit, spp, per_half):
    """A unit is a whole page up to 8 KiB, else 8 KiB parts of it; a 16
    KiB half-buffer holds as many units as fit, at most one a lane."""
    p = RC.gather_plan(1000, page_bytes, 10**6)
    assert (p.unit_vecs, p.spp, p.per_half) == (unit, spp, per_half)
    assert p.n_batches == -(-1000 * spp // 32)
    assert p.blocks == -(-p.n_batches // RC.GATHER_WARPS)
    assert RC.gather_plan(1000, page_bytes, 3).blocks == 3
