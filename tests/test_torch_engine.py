"""The same request stream through the reference Engine (JAX CPU, Pallas
interpret) and the port's Engine (CPU): equal tokens, equal stats including
the modeled movement costs, equal VILLA policy state, and session stores
that agree (positions exact, K/V at valid positions to f32 noise, 1e-4)."""
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import lm as R_lm
from repro.serve.engine import Engine as REngine
from repro.serve.engine import Request as RRequest
from repro_torch import resolve_device
from repro_torch.serve.engine import Engine as PEngine
from repro_torch.serve.engine import EngineFull, Request, UnknownSession
from repro_torch.weights import params_from_jax

KW = dict(slots=4, max_len=96, n_sessions=8)


@pytest.fixture(scope="module")
def engines():
    cfg = get_reduced("tinyllama-1.1b")
    rparams = R_lm.init_lm(cfg, jax.random.key(0))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    return REngine(cfg, rparams, **KW), PEngine(cfg, pparams, device="cpu",
                                                **KW)


def _same_engines(r, p):
    assert p.stats == r.stats
    assert p.session_pos == r.session_pos
    assert p.session_tok == r.session_tok
    assert p.store_uid == r.store_uid
    assert (p.forks.phys_of, p.forks.refs) == (r.forks.phys_of, r.forks.refs)
    assert list(p.pos) == list(r.pos)
    assert sorted(p.active) == sorted(r.active)
    rs, ps = r.sessions, p.sessions
    for name in ("counters", "hot", "tags", "benefit", "tick"):
        np.testing.assert_array_equal(getattr(ps.policy, name).numpy(),
                                      np.asarray(getattr(rs.policy, name)))
    assert (int(ps.hits), int(ps.accesses)) == (int(rs.hits), int(rs.accesses))
    assert p.fast_resident_uids() == r.fast_resident_uids()
    assert p.hit_rate() == pytest.approx(r.hit_rate())
    _same_store(r, p)


def _same_store(r, p):
    """Every live snapshot row, leaf by leaf."""
    spec = p.page_spec
    rslow = np.asarray(r.sessions.slow)
    pslow = p.sessions.slow.numpy()
    for idx in sorted(r.store_uid):
        rb, pb = rslow[idx].reshape(-1), pslow[idx].reshape(-1)
        leaves = {}
        for shape, dt, off in zip(spec.leaf_shapes, spec.leaf_dtypes,
                                  spec.leaf_offsets):
            n = math.prod(shape) * 4
            leaves[off] = (rb[off:off + n].view(np.float32 if dt ==
                                                 torch.float32 else np.int32)
                           .reshape(shape),
                           pb[off:off + n].view(np.float32 if dt ==
                                                 torch.float32 else np.int32)
                           .reshape(shape))
        (rk, pk), (rpos, ppos), (rv, pv) = (leaves[o] for o in
                                            spec.leaf_offsets)
        np.testing.assert_array_equal(ppos, rpos)
        valid = rpos < 2**30
        np.testing.assert_allclose(pk[valid], rk[valid], rtol=0, atol=1e-4)
        np.testing.assert_allclose(pv[valid], rv[valid], rtol=0, atol=1e-4)


def _both(engines, name, *args):
    r, p = engines
    out = [getattr(e, name)(*args) for e in (r, p)]
    assert out[0] == out[1], (name, out)
    return out[0]


def _drain(engines):
    r, p = engines
    while r.active:
        rc, pc = r.step(), p.step()
        assert [(s, q.uid, q.generated) for s, q in rc] == \
            [(s, q.uid, q.generated) for s, q in pc]
    assert not p.active


def test_engine_stream_matches_reference(engines):
    r, p = engines
    cfg = r.cfg
    rng = np.random.default_rng(10)
    reqs = []
    for uid, (n, max_new) in enumerate([(6, 5), (9, 7), (12, 5), (15, 9)]):
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        rq, pq = RRequest(uid, prompt, max_new), Request(uid, prompt, max_new)
        assert r.submit(rq) == p.submit(pq)
        reqs.append((rq, pq))
    with pytest.raises(EngineFull):
        p.submit(Request(9, np.zeros(3, np.int32), 2))
    _drain(engines)                          # uids 0 and 2 finish together
    for rq, pq in reqs:
        assert pq.generated == rq.generated
    assert p.stats["suspends"] == 4
    _same_engines(r, p)

    _both(engines, "resume_many", [0, 2], [4, 6])
    _both(engines, "resume", 1, 3)
    _drain(engines)
    _same_engines(r, p)

    # forks alias uid 3's row; their suspends break CoW onto rows 2 and 3,
    # evicting uid 2 and demoting the shared row
    _both(engines, "fork_many", 3, [10, 11], [5, 6])
    _both(engines, "resume_many", [10, 11], 4)
    _drain(engines)
    assert p.stats["forks"] == 2 and p.stats["demotions"] >= 1
    assert p.stats["evictions"] >= 1
    _same_engines(r, p)
    with pytest.raises(UnknownSession):
        p.resume(2, 2)

    for _ in range(5):                       # hot resumes reach the fast tier
        for uid in (0, 3):
            _both(engines, "resume", uid, 2)
            _drain(engines)
    assert p.sessions.hits.item() > 0
    _same_engines(r, p)


def test_corruption_is_detected_like_the_reference(engines):
    r, p = engines
    idx = r.forks.resolve(0)
    assert p.forks.resolve(0) == idx
    for e in (r, p):
        e.corrupt_stored(idx, 1, 200, 0x10)
    assert int(p.verify_store()) == int(r.verify_store()) == 1
    _both(engines, "resume", 0, 2)
    assert p.verify_failure_count() == r.verify_failure_count() == 1
    _drain(engines)
    _same_engines(r, p)


def test_entry_points_need_a_device_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def _constructors():
    from repro_torch.configs import get_reduced as p_reduced
    from repro_torch.core.dram.villa import VillaConfig, villa_init
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.movement.paging import PageSpec
    from repro_torch.serve.paged_store import make_session_store
    from repro_torch.weights import params_from_jax

    cfg = p_reduced("tinyllama-1.1b")
    gen = torch.Generator().manual_seed(0)
    spec = PageSpec.for_cache(lm.init_cache(cfg, 1, 16, device="cpu"))
    params = lm.init_lm(cfg, gen, device="cpu")
    return {
        "init_lm": lambda **kw: lm.init_lm(cfg, gen, **kw),
        "init_cache": lambda **kw: lm.init_cache(cfg, 1, 16, **kw),
        "Engine": lambda **kw: PEngine(cfg, params, slots=1, max_len=16,
                                       n_sessions=2, **kw),
        "params_from_jax": lambda **kw: params_from_jax(
            {"w": np.zeros(3, np.float32)}, **kw),
        "make_session_store": lambda **kw: make_session_store(
            spec, 2, VillaConfig(n_counters=2, n_hot=1, n_slots=1), **kw),
        "villa_init": lambda **kw: villa_init(VillaConfig(), **kw),
        "init_gqa_params": lambda **kw: A.init_gqa_params(
            gen, 8, 2, 1, 4, qkv_bias=True, **kw),
        "init_mlp": lambda **kw: L.init_mlp(gen, 8, 16, **kw),
        "init_embed": lambda **kw: L.init_embed(gen, 10, 8, **kw),
        "dense_init": lambda **kw: L.dense_init(gen, (8, 4), **kw),
        "init_rms": lambda **kw: L.init_rms(8, **kw),
        "rope_freqs": lambda **kw: L.rope_freqs(8, 1e4, **kw),
    }


@pytest.mark.parametrize("name", [
    "init_lm", "init_cache", "Engine", "params_from_jax", "make_session_store",
    "villa_init", "init_gqa_params", "init_mlp", "init_embed", "dense_init",
    "init_rms", "rope_freqs"])
def test_constructors_need_a_device_without_a_gpu(name, monkeypatch):
    """Every public constructor runs on cuda by default: without a GPU and
    without ``device`` it raises; with ``device="cpu"`` all its tensors are
    on the CPU."""
    make = _constructors()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    tensors = list(_tensors(make(device="cpu")))
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, PEngine):
        yield from _tensors((x.params, x.cache, x.sessions))
    elif isinstance(x, (dict, tuple)):
        for v in (x.values() if isinstance(x, dict) else x):
            yield from _tensors(v)
