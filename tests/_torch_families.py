"""Model-level parity checks shared by the dense, MoE and MLA families'
tests (tests/test_torch_dense.py, tests/test_torch_moe.py,
tests/test_torch_mla.py): a reduced config run by the reference and by the
port from the reference's own weights (``params_from_jax``), f32
throughout.

- prefill of four bucketed prompts: logits and cache at ATOL (1e-4, the bar
  of tests/test_torch_lm.py), then 48 teacher-forced ragged decode steps,
  one row idling for ten: greedy tokens equal, the cache at ATOL;
- an Engine stream with a suspend wave and a resume wave: tokens step by
  step, stats, session positions and tokens equal, and every stored
  snapshot equal leaf by leaf in its page bytes (positions exactly, float
  leaves at ATOL where a position is valid).

Cache slots holding no token carry position 2**30, whose RoPE angle the
two frameworks round differently; they are never attended, so float
leaves are compared at valid positions only."""
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import lm as R_lm
from repro.serve.engine import Engine as REngine
from repro.serve.engine import Request as RRequest
from repro_torch.models import lm as P_lm
from repro_torch.serve.engine import Engine as PEngine
from repro_torch.serve.engine import Request
from repro_torch.weights import params_from_jax

ATOL, SLOTS, MAX_LEN, STEPS = 1e-4, 4, 96, 48
PROMPTS = (6, 9, 12, 15)


def both_params(cfg, seed, dtype=jnp.float32):
    rparams = R_lm.init_lm(cfg, jax.random.key(seed), dtype=dtype)
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    return rparams, pparams


def _blocks(cache):
    for st in sorted(cache):
        for b in sorted(cache[st]):
            yield f"{st}/{b}", cache[st][b]


def same_cache(pc, rc, atol=ATOL):
    """Every block: the same leaves, positions exactly, float leaves at
    ``atol`` where the position is valid."""
    pb, rb = dict(_blocks(pc)), dict(_blocks(rc))
    assert pb.keys() == rb.keys()
    for name, r in rb.items():
        assert sorted(pb[name]) == sorted(r)
        rpos = np.asarray(r["pos"])
        np.testing.assert_array_equal(pb[name]["pos"].numpy(), rpos,
                                      err_msg=name)
        valid = rpos < 2**30
        for k in sorted(r):
            if k != "pos":
                np.testing.assert_allclose(
                    pb[name][k].float().numpy()[valid],
                    np.asarray(r[k].astype(jnp.float32))[valid], rtol=0,
                    atol=atol, err_msg=f"{name}/{k}")


def _padded(prompt, lb=16):
    toks = np.zeros(lb, np.int32)
    toks[:len(prompt)] = prompt
    pos = np.full(lb, 2**30, np.int32)
    pos[:len(prompt)] = np.arange(len(prompt))
    return toks, pos


def prefill_and_ragged_decode(cfg, rparams, pparams, seed=9):
    """Bucketed prefills (right-padded to 16 with 2**30 positions) into
    four rows, then STEPS teacher-forced decode steps with row 1 idle for
    ten: logits and caches at ATOL, greedy tokens equal."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]
    rcache = R_lm.init_cache(cfg, SLOTS, max_len=MAX_LEN)
    pcache = P_lm.init_cache(cfg, SLOTS, MAX_LEN, device="cpu")
    r_prefill = jax.jit(partial(R_lm.prefill, cfg))
    for s, prompt in enumerate(prompts):
        toks, pos = _padded(prompt)
        c1 = R_lm.init_cache(cfg, 1, max_len=MAX_LEN)
        rlog, c1 = r_prefill(rparams, jnp.asarray(toks)[None], c1,
                             positions=jnp.asarray(pos)[None])
        rcache = jax.tree.map(
            lambda full, p: jax.lax.dynamic_update_slice_in_dim(
                full, p, s, axis=1), rcache, c1)
        plog, _ = P_lm.prefill(cfg, pparams, torch.from_numpy(toks)[None],
                               pcache, positions=torch.from_numpy(pos)[None],
                               slot=s)
        n = len(prompt)
        np.testing.assert_allclose(plog[0, :n].numpy(),
                                   np.asarray(rlog[0, :n]), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(plog[0, :n].numpy().argmax(-1),
                                      np.asarray(rlog[0, :n]).argmax(-1))
    same_cache(pcache, rcache)

    r_decode = jax.jit(partial(R_lm.decode_step_batched, cfg))
    pos = np.array(PROMPTS, np.int32)
    for step in range(STEPS):
        toks = rng.integers(0, cfg.vocab_size, SLOTS).astype(np.int32)
        active = np.ones(SLOTS, bool)
        if 10 <= step < 20:
            active[1] = False
        rn, rcache = r_decode(rparams, rcache, jnp.asarray(toks),
                              jnp.asarray(pos), jnp.asarray(active))
        pn, pcache = P_lm.decode_step_batched(
            cfg, pparams, pcache, torch.from_numpy(toks),
            torch.from_numpy(pos), active)
        np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
        pos = pos + active
    same_cache(pcache, rcache)


def _same_store(r, p):
    """Every stored snapshot row, leaf by leaf from its page bytes:
    positions exactly, float leaves at ATOL where their block's position
    is valid (the leaves run block by block in sorted key order, as the
    reference flattens its cache)."""
    spec = p.page_spec
    rslow, pslow = np.asarray(r.sessions.slow), p.sessions.slow.numpy()
    assert rslow.shape == pslow.shape
    blocks = [(name, sorted(c)) for name, c in _blocks(p.cache)]
    leaves = iter(zip(spec.leaf_shapes, spec.leaf_dtypes, spec.leaf_offsets))
    view = lambda buf, shape, dt, off: buf[          # noqa: E731
        off:off + math.prod(shape) * 4].view(
            np.float32 if dt == torch.float32 else np.int32).reshape(shape)
    laid = [(name, {k: next(leaves) for k in keys}) for name, keys in blocks]
    assert next(leaves, None) is None
    for idx in sorted(r.store_uid):
        rb, pb = rslow[idx].reshape(-1), pslow[idx].reshape(-1)
        for name, block in laid:
            rpos = view(rb, *block["pos"])
            np.testing.assert_array_equal(view(pb, *block["pos"]), rpos,
                                          err_msg=name)
            valid = rpos < 2**30
            for k, leaf in block.items():
                if k != "pos":
                    np.testing.assert_allclose(
                        view(pb, *leaf)[valid], view(rb, *leaf)[valid],
                        rtol=0, atol=ATOL, err_msg=f"{name}/{k}")


def _step(r, p):
    assert [(s, q.uid, q.generated) for s, q in r.step()] == \
        [(s, q.uid, q.generated) for s, q in p.step()]


def _drain(r, p):
    while r.active:
        _step(r, p)
    assert not p.active


def engine_stream_with_waves(cfg, rparams, pparams, seed=4):
    """The same requests through both Engines: bucketed prefills, a suspend
    wave of two sessions, the rest drained (finishers suspend as a wave),
    then a resume wave: tokens step by step, stats, session positions and
    tokens, and every stored snapshot equal; no resume failing its
    checksums."""
    kw = dict(slots=SLOTS, max_len=64, n_sessions=8)
    r, p = REngine(cfg, rparams, **kw), PEngine(cfg, pparams, device="cpu",
                                                **kw)
    assert p._can_bucket and r._can_bucket
    assert p.page_spec.leaf_shapes == r.page_spec.leaf_shapes
    assert p.page_spec.leaf_offsets == r.page_spec.leaf_offsets
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 11, 17, 20)]
    reqs = []
    for uid, prompt in enumerate(prompts):
        rq, pq = RRequest(uid, prompt, 14), Request(uid, prompt, 14)
        assert r.submit(rq) == p.submit(pq)
        reqs.append((rq, pq))
    for _ in range(5):
        _step(r, p)
    r.suspend_many([0, 2]), p.suspend_many([0, 2])
    _same_store(r, p)
    _drain(r, p)
    r.resume_many([0, 2], [9, 9]), p.resume_many([0, 2], [9, 9])
    _drain(r, p)
    for rq, pq in reqs:
        assert pq.generated == rq.generated
    assert p.stats == r.stats and p.stats["resumes"] == 2
    assert p.session_pos == r.session_pos
    assert p.session_tok == r.session_tok
    assert p.snapshot_bytes == r.snapshot_bytes
    _same_store(r, p)
    assert p.verify_failure_count() == r.verify_failure_count() == 0
    assert int(p.verify_store()) == 0
