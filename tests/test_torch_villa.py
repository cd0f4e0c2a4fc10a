"""VILLA policy and the tiered store: the port bit-exact against the
reference on the same access/write streams (reference on JAX CPU, its page
kernels in Pallas interpret mode; port on the CPU, plain page copies)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro.core.dram import villa as RV
from repro.core.lisa import villa_cache as RC
from repro_torch.core.dram import villa as PV
from repro_torch.core.lisa import villa_cache as PC

CFG_KW = dict(n_counters=8, n_hot=2, n_slots=3, epoch_len=5)
R_CFG, P_CFG = RV.VillaConfig(**CFG_KW), PV.VillaConfig(**CFG_KW)


def _same_state(p, r):
    for name in ("counters", "hot", "tags", "benefit", "tick"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(r, name)), name)


@functools.lru_cache(maxsize=None)
def _r_access():
    return jax.jit(RV.villa_access, static_argnums=2)


@pytest.mark.parametrize("stream", ["random", "ties"])
def test_villa_access_bit_exact(stream):
    """Random streams, and a round-robin stream whose counters tie (the
    epoch then marks more than n_hot rows hot and argmin meets equal
    benefits: both take the first minimum)."""
    rng = np.random.default_rng(1)
    if stream == "random":
        rows = rng.integers(0, 12, 120)
    else:
        rows = np.tile(np.arange(6), 20)
    r, p = RV.villa_init(R_CFG), PV.villa_init(P_CFG, "cpu")
    marked_more = False
    for row in rows:
        r, rh, ri, rvic = _r_access()(r, jnp.int32(row), R_CFG)
        p, ph, pi, pvic = PV.villa_access(p, int(row), P_CFG)
        assert (bool(ph), bool(pi)) == (bool(rh), bool(ri))
        assert int(pvic) == int(rvic)
        _same_state(p, r)
        marked_more |= int(p.hot.sum()) > P_CFG.n_hot
    if stream == "ties":
        assert marked_more


def test_villa_epoch_ties_and_argmin_first():
    counters = np.array([3, 5, 5, 5, 1, 0, 2, 5], np.int32)
    r = RV.villa_init(R_CFG)._replace(counters=jnp.asarray(counters))
    p = PV.villa_init(P_CFG, "cpu")._replace(counters=torch.from_numpy(counters))
    _same_state(PV.villa_epoch(p, P_CFG), RV.villa_epoch(r, R_CFG))
    assert int(PV.villa_epoch(p, P_CFG).hot.sum()) == 4   # 4 ties at 5
    b = torch.tensor([2, 1, 1], dtype=torch.int32)
    assert int(torch.argmin(b)) == int(jnp.argmin(jnp.asarray(b.numpy()))) == 1


SPP, N_ITEMS = 3, 6


def _same_store(p, r):
    _same_state(p.policy, r.policy)
    for name in ("fast", "slow", "hits", "accesses"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(r, name)), name)


@pytest.fixture(scope="module")
def r_fns():
    return (jax.jit(RC.access, static_argnums=2), jax.jit(RC.write),
            jax.jit(RC.access_many, static_argnums=2), jax.jit(RC.write_many),
            jax.jit(RC.clone_item))


def test_tiered_store_bit_exact(r_fns):
    r_access, r_write, r_access_many, r_write_many, r_clone = r_fns
    rng = np.random.default_rng(2)
    slow0 = rng.integers(0, 256, (N_ITEMS, SPP, 8, 128), dtype=np.uint8)
    r = RC.make_store(jnp.asarray(slow0), R_CFG)
    p = PC.make_store(torch.from_numpy(slow0.copy()), P_CFG)
    for step in range(30):
        item = int(rng.integers(0, N_ITEMS))
        if rng.random() < 0.6:
            r, rd, rh = r_access(r, jnp.int32(item), R_CFG)
            p, pd, ph = PC.access(p, item, P_CFG)
            np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
            assert bool(ph) == bool(rh)
        else:
            data = rng.integers(0, 256, (SPP, 8, 128), dtype=np.uint8)
            r = r_write(r, jnp.int32(item), jnp.asarray(data))
            p = PC.write(p, item, torch.from_numpy(data))
        _same_store(p, r)
    assert int(p.hits) > 0 and int(p.policy.tags.max()) >= 0
    # a wave, in order, with a duplicate
    items = np.array([1, 4, 1, 2], np.int32)
    r, rd, rh = r_access_many(r, jnp.asarray(items), R_CFG)
    p, pd, ph = PC.access_many(p, items, P_CFG)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(rh))
    data = rng.integers(0, 256, (4, SPP, 8, 128), dtype=np.uint8)
    r = r_write_many(r, jnp.asarray(items), jnp.asarray(data))
    p = PC.write_many(p, items, torch.from_numpy(data))
    _same_store(p, r)
    # clone a resident row over another (drops the destination's residency)
    src = int(np.asarray(r.policy.tags)[np.asarray(r.policy.tags) >= 0][0])
    dst = (src + 1) % N_ITEMS
    r = r_clone(r, jnp.int32(src), jnp.int32(dst))
    p = PC.clone_item(p, src, dst)
    _same_store(p, r)
    assert float(PC.hit_rate(p)) == pytest.approx(float(RC.hit_rate(r)))


def _wave_events(policy, items):
    """What a wave asks of the batched path, from the policy alone: hits
    on items resident before it, evictions of a resident item inside it,
    and hits on a slot that an earlier item of the same wave filled."""
    ev = {"resident_hits": 0, "evictions": 0, "filled_hits": 0}
    filled = set()
    for item in items:
        before = policy.tags.clone()
        policy, hit, insert, victim = PV.villa_access(policy, int(item),
                                                      P_CFG)
        slot = int(torch.argmax((policy.tags == int(item)).to(torch.int32)))
        if bool(hit):
            ev["filled_hits" if slot in filled else "resident_hits"] += 1
        if bool(insert):
            ev["evictions"] += int(before[int(victim)] >= 0)
            filled.add(int(victim))
    return ev


@pytest.mark.parametrize("seed", range(4))
def test_random_waves_bit_exact(r_fns, seed):
    """access_many/write_many against the reference's over random waves of
    1-6 items: duplicates, evictions inside a wave, items resident before
    it and hits on a slot the wave itself filled.  Data, hits and the
    whole store agree after every wave."""
    _, _, r_access_many, r_write_many, _ = r_fns
    rng = np.random.default_rng(100 + seed)
    slow0 = rng.integers(0, 256, (N_ITEMS, SPP, 8, 128), dtype=np.uint8)
    r = RC.make_store(jnp.asarray(slow0), R_CFG)
    p = PC.make_store(torch.from_numpy(slow0.copy()), P_CFG)
    seen = {"duplicates": 0, "resident_hits": 0, "evictions": 0,
            "filled_hits": 0}
    for _ in range(40):
        k = int(rng.integers(1, 7))
        items = rng.integers(0, N_ITEMS, k).astype(np.int32)
        seen["duplicates"] += k - len(set(items.tolist()))
        if rng.random() < 0.7:
            for key, n in _wave_events(p.policy, items).items():
                seen[key] += n
            r, rd, rh = r_access_many(r, jnp.asarray(items), R_CFG)
            p, pd, ph = PC.access_many(p, items, P_CFG)
            np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
            np.testing.assert_array_equal(ph.numpy(), np.asarray(rh))
        else:
            data = rng.integers(0, 256, (k, SPP, 8, 128), dtype=np.uint8)
            r = r_write_many(r, jnp.asarray(items), jnp.asarray(data))
            p = PC.write_many(p, items, torch.from_numpy(data))
        _same_store(p, r)
    assert all(n > 0 for n in seen.values()), seen
