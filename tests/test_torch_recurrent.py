"""The recurrent families against the reference: ``models/ssm.py`` (mamba)
and ``models/rwkv.py`` (RWKV-6) block by block, and reduced jamba-v0.1-52b
(mamba + attention + MoE) and rwkv6-7b as models, f32 throughout but the
bf16 layout check.

- ``mamba_block`` in its three branches (no state; the S == 1 closed form
  from a state; the scan from a state, i.e. prefill) and ``rwkv_time_mix``
  / ``rwkv_channel_mix`` without and with a state at S == 1 and S > 1: the
  outputs and the new states within BAR (3e-5) of the reference's, from the
  reference's own weights and random states.
- ``forward`` and the f32 ``decode_step`` of both models within BAR.
- The snapshot layout of f32 and bf16 caches (shapes, byte offsets and
  dtypes: ``ssm``/``wkv`` f32, ``conv`` and the shifts the cache's) equals
  the reference's, and a slot packed and unpacked comes back bit for bit.
- prefill, then ragged ``decode_step_batched`` steps with one row idle:
  tokens equal, states within BAR, and the idle row's state leaves
  bit-exact.
- The Engine (exact-length prefills, as the reference's ``_can_bucket``
  keeps state layers) with a suspend and a resume wave: tokens, stats and
  sessions equal the reference Engine's, resumed tokens equal the port's
  uninterrupted run, the stored snapshots' state leaves within BAR of the
  reference's, and the port's stored page bytes equal to what the
  reference's ``pack_slot`` makes of the port's own cache.
- Both launchers serve reduced jamba and rwkv6 to the same JSON.

BAR is the kernel bar of the f32 routes: the two frameworks compute the
same f32 steps in another order of summation (matmuls, einsums), which at
these widths moves the outputs by at most a few 1e-6 (logits of magnitude
~4)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs import get_reduced
from repro.launch.serve import main as r_main
from repro.models import lm as R_lm
from repro.models import rwkv as R_rwkv
from repro.models import ssm as R_ssm
from repro.movement import paging as R_paging
from repro.serve.engine import Engine as REngine
from repro.serve.engine import Request as RRequest
from repro_torch.launch.serve import main as p_main
from repro_torch.models import lm as P_lm
from repro_torch.models import rwkv as P_rwkv
from repro_torch.models import ssm as P_ssm
from repro_torch.serve.engine import Engine as PEngine
from repro_torch.serve.engine import Request
from repro_torch.weights import params_from_jax

BAR = 3e-5
ARCHS = ("jamba-v0.1-52b", "rwkv6-7b")
WALL_CLOCK = ("tokens_per_s", "seconds", "decode_compile_count")


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if hasattr(x, "astype") and \
        not isinstance(x, torch.Tensor) else x.float().numpy()


def _close(p, r, bar=BAR, what=""):
    np.testing.assert_allclose(_np(p), _np(r), rtol=0, atol=bar, err_msg=what)


def _both(tree):
    return tree, params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = get_reduced(request.param)
    rparams, pparams = _both(R_lm.init_lm(cfg, jax.random.key(7)))
    return cfg, rparams, pparams


# ---- blocks ----------------------------------------------------------------

@pytest.mark.parametrize("branch,S", [("none", 12), ("decode", 1),
                                      ("prefill", 7), ("prefill", 2)])
def test_mamba_block_matches_reference(branch, S):
    cfg = get_reduced("jamba-v0.1-52b")
    rp, pp = _both(R_ssm.init_mamba_params(jax.random.key(2), cfg.d_model,
                                           cfg.d_state, cfg.d_conv,
                                           cfg.expand))
    rng = np.random.default_rng(3)
    B, d_inner = 3, cfg.expand * cfg.d_model
    x = _x(rng, B, S, cfg.d_model)
    kw = dict(d_state=cfg.d_state, d_conv=cfg.d_conv, expand=cfg.expand)
    rstate = pstate = None
    if branch != "none":
        conv = _x(rng, B, cfg.d_conv - 1, d_inner)
        ssm = _x(rng, B, d_inner, cfg.d_state)
        rstate = R_ssm.MambaState(jnp.asarray(conv), jnp.asarray(ssm))
        pstate = P_ssm.MambaState(torch.from_numpy(conv),
                                  torch.from_numpy(ssm))
    ry, rnew = R_ssm.mamba_block(rp, jnp.asarray(x), chunk=cfg.scan_chunk,
                                 state=rstate, **kw)
    py, pnew = P_ssm.mamba_block(pp, torch.from_numpy(x), state=pstate, **kw)
    _close(py, ry, what="y")
    if branch == "none":
        assert rnew is None and pnew is None
        return
    assert pnew.ssm.dtype == torch.float32
    _close(pnew.conv, rnew.conv, what="conv")
    _close(pnew.ssm, rnew.ssm, what="ssm")


@pytest.mark.parametrize("branch,S", [("none", 12), ("decode", 1),
                                      ("prefill", 9)])
def test_rwkv_mixes_match_reference(branch, S):
    cfg = get_reduced("rwkv6-7b")
    rp, pp = _both(R_rwkv.init_rwkv_params(jax.random.key(4), cfg.d_model,
                                           cfg.d_ff))
    rng = np.random.default_rng(5)
    B, M, H = 2, cfg.d_model, cfg.d_model // 64
    x = _x(rng, B, S, M)
    rstate = pstate = None
    if branch != "none":
        att, ffn = _x(rng, B, M), _x(rng, B, M)
        wkv = _x(rng, B, H, 64, 64)
        rstate = R_rwkv.RWKVState(*map(jnp.asarray, (att, ffn, wkv)))
        pstate = P_rwkv.RWKVState(*map(torch.from_numpy, (att, ffn, wkv)))
    ry, rnew = R_rwkv.rwkv_time_mix(rp, jnp.asarray(x), chunk=cfg.scan_chunk,
                                    state=rstate)
    py, pnew = P_rwkv.rwkv_time_mix(pp, torch.from_numpy(x), state=pstate)
    _close(py, ry, what="time mix")
    ry2, rshift = R_rwkv.rwkv_channel_mix(rp, jnp.asarray(x), state=rstate)
    py2, pshift = P_rwkv.rwkv_channel_mix(pp, torch.from_numpy(x),
                                          state=pstate)
    _close(py2, ry2, what="channel mix")
    if branch == "none":
        assert rnew is None and pnew is None and pshift is None
        return
    _close(pnew[0], rnew[0], 0, "att_shift")
    _close(pnew[1], rnew[1], what="wkv")
    _close(pshift, rshift, 0, "ffn_shift")


def test_wkv_decay_and_group_norm_at_their_edges():
    """The decay's clip at -20 and 1 (dd past both ends) and the group
    norm's population variance (a head of equal outputs: var 0)."""
    cfg = get_reduced("rwkv6-7b")
    rp, pp = _both(R_rwkv.init_rwkv_params(jax.random.key(6), cfg.d_model,
                                           cfg.d_ff))
    for name, v in (("w0", 30.0), ("w0", -40.0)):
        rq = dict(rp, **{name: jnp.full_like(rp[name], v)})
        pq = dict(pp, **{name: torch.full_like(pp[name], v)})
        x = _x(np.random.default_rng(7), 2, 5, cfg.d_model)
        ry, _ = R_rwkv.rwkv_time_mix(rq, jnp.asarray(x), chunk=4)
        py, _ = P_rwkv.rwkv_time_mix(pq, torch.from_numpy(x))
        _close(py, ry, what=f"{name}={v}")
    r = torch.ones(1, 1, 1, 64)
    out, _ = P_rwkv._wkv_scan(r, r, r, r * 0.5, torch.zeros(1, 64), None)
    assert float(out.var(-1, correction=0).max()) == 0.0


# ---- models ----------------------------------------------------------------

def test_params_layout_matches_reference(model):
    cfg, rparams, pparams = model
    own = P_lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(rparams)[0]:
        for tree in (pparams, own):
            node = tree
            for k in path:
                node = node[k.key]
            assert tuple(node.shape) == leaf.shape, path
            assert str(node.dtype) == f"torch.{leaf.dtype}", path


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_weights_keep_their_f32_leaves(arch):
    """Under bf16 weights the reference keeps A_log, D and dt_bias (mamba)
    and mu_*, w0, u and ln_x (rwkv) in f32; the port's own init and
    ``params_from_jax`` keep each leaf's dtype."""
    cfg = get_reduced(arch)
    rparams = R_lm.init_lm(cfg, jax.random.key(1), dtype=jnp.bfloat16)
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams),
                              device="cpu")
    own = P_lm.init_lm(cfg, torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16, device="cpu")
    kept = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(rparams)[0]:
        for tree in (pparams, own):
            node = tree
            for k in path:
                node = node[k.key]
            assert str(node.dtype) == f"torch.{leaf.dtype}", path
        kept += (leaf.dtype == jnp.float32 and len(path) > 2
                 and path[-2].key == "mixer")
    assert kept >= (3 if arch.startswith("jamba") else 8)


def test_init_cache_matches_reference(model):
    cfg, _, _ = model
    want = R_lm.init_cache(cfg, 3, max_len=20)
    got = P_lm.init_cache(cfg, 3, 20, device="cpu")
    assert sorted(got) == sorted(want)
    for st in want:
        assert sorted(got[st]) == sorted(want[st])
        for b in want[st]:
            assert sorted(got[st][b]) == sorted(want[st][b])
            for k, r in want[st][b].items():
                p = got[st][b][k]
                assert tuple(p.shape) == r.shape, (st, b, k)
                assert str(p.dtype) == f"torch.{r.dtype}", (st, b, k)
                np.testing.assert_array_equal(p.numpy(), np.asarray(r))


def test_forward_and_decode_step_match_reference(model):
    cfg, rparams, pparams = model
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 14)
                                             ).astype(np.int32)
    rlog, _, _ = R_lm.forward(cfg, rparams, jnp.asarray(toks))
    plog, _, _ = P_lm.forward(cfg, pparams, torch.from_numpy(toks))
    _close(plog, rlog, what="forward")
    rc = R_lm.init_cache(cfg, 2, max_len=16)
    pc = P_lm.init_cache(cfg, 2, 16, device="cpu")
    step = jax.jit(lambda p, c, t, pos: R_lm.decode_step(cfg, p, c, t, pos))
    for t in range(toks.shape[1]):
        rl, rc = step(rparams, rc, jnp.asarray(toks[:, t:t + 1]),
                      jnp.int32(t))
        pl, pc = P_lm.decode_step(cfg, pparams, pc,
                                  torch.from_numpy(toks[:, t:t + 1]), t)
        _close(pl, rl, what=f"decode step {t}")
    _close(pl[:, 0], plog[:, -1], what="decode against forward")
    _same_cache(pc, rc)


def _same_cache(pc, rc, bar=BAR):
    """Every block's leaves: positions exactly; floats within ``bar``, where
    their position is valid for K/V, everywhere for a state."""
    for st in rc:
        for b, r in rc[st].items():
            p = pc[st][b]
            assert sorted(p) == sorted(r)
            valid = None
            if "pos" in r:
                rpos = np.asarray(r["pos"])
                np.testing.assert_array_equal(p["pos"].numpy(), rpos)
                valid = rpos < 2**30
            for k in r:
                if k == "pos":
                    continue
                got, want = _np(p[k]), _np(r[k])
                if valid is not None:
                    got, want = got[valid], want[valid]
                np.testing.assert_allclose(got, want, rtol=0, atol=bar,
                                           err_msg=f"{st}/{b}/{k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_pages_keep_each_leaf_dtype(model, dtype):
    """A cache's snapshot layout equals the reference's leaf for leaf:
    ``ssm``/``wkv`` f32, ``conv`` and the shifts (and K/V) in the cache's
    dtype, at the same byte offsets; a slot packed and unpacked into
    another comes back bit for bit."""
    from repro_torch.movement import paging as P_paging

    cfg, _, _ = model
    rc = R_lm.init_cache(cfg, 2, max_len=20, dtype=jnp.dtype(dtype))
    pc = P_lm.init_cache(cfg, 2, 20, dtype=getattr(torch, dtype),
                         device="cpu")
    rs, ps = R_paging.PageSpec.for_cache(rc), P_paging.PageSpec.for_cache(pc)
    assert ps.leaf_shapes == rs.leaf_shapes
    assert ps.leaf_offsets == rs.leaf_offsets
    assert [str(d).removeprefix("torch.") for d in ps.leaf_dtypes] == \
        [str(d) for d in rs.leaf_dtypes]
    assert {str(d) for d in rs.leaf_dtypes} >= {"float32", dtype}
    g = torch.Generator().manual_seed(3)
    for t in P_paging.cache_leaves(pc):
        t.copy_(torch.randn(t.shape, generator=g).mul(100).to(t.dtype))
    pages = P_paging.pack_slot(ps, pc, 0)
    P_paging.unpack_into_slot(ps, pc, 1, pages)
    for t in P_paging.cache_leaves(pc):
        assert torch.equal(t[:, 0].contiguous().view(torch.uint8),
                           t[:, 1].contiguous().view(torch.uint8))


def test_prefill_and_ragged_decode_keep_an_idle_row(model):
    """Exact-length prefills into rows 0-2, then 10 ragged decode steps
    with row 1 idle for steps 3-6: tokens equal the reference's, caches
    within BAR, and the idle row's cache leaves keep their bits."""
    cfg, rparams, pparams = model
    rng = np.random.default_rng(9)
    slots, max_len = 3, 48
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 1)]
    rc = R_lm.init_cache(cfg, slots, max_len=max_len)
    pc = P_lm.init_cache(cfg, slots, max_len, device="cpu")
    for s, prompt in enumerate(prompts):
        c1 = R_lm.init_cache(cfg, 1, max_len=max_len)
        rl, c1 = R_lm.prefill(cfg, rparams, jnp.asarray(prompt)[None], c1)
        rc = jax.tree.map(lambda full, one: jax.lax.dynamic_update_slice_in_dim(
            full, one, s, axis=1), rc, c1)
        pl, _ = P_lm.prefill(cfg, pparams, torch.from_numpy(prompt)[None], pc,
                             slot=s)
        _close(pl, rl, what=f"prefill {s}")
    _same_cache(pc, rc)
    step = jax.jit(lambda p, c, t, pos, a: R_lm.decode_step_batched(
        cfg, p, c, t, pos, a))
    pos = np.array([len(p) for p in prompts], np.int32)
    for i in range(10):
        toks = rng.integers(0, cfg.vocab_size, slots).astype(np.int32)
        active = np.ones(slots, bool)
        active[1] = not 3 <= i < 7
        before = [t[:, 1].clone() for t in _leaves(pc)]
        rn, rc = step(rparams, rc, jnp.asarray(toks), jnp.asarray(pos),
                      jnp.asarray(active))
        pn, pc = P_lm.decode_step_batched(cfg, pparams, pc,
                                          torch.from_numpy(toks),
                                          torch.from_numpy(pos), active)
        np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
        if not active[1]:
            for a, t in zip(before, _leaves(pc)):
                assert torch.equal(a.view(torch.uint8),
                                   t[:, 1].contiguous().view(torch.uint8))
        pos = pos + active
    _same_cache(pc, rc)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


# ---- serving ---------------------------------------------------------------

def _step(r, p):
    assert [(s, q.uid, q.generated) for s, q in r.step()] == \
        [(s, q.uid, q.generated) for s, q in p.step()]


def _drain(r, p):
    while r.active:
        _step(r, p)
    assert not p.active


def _pages_of(p, slot):
    """What the reference's ``pack_slot`` makes of the port's cache row."""
    cache = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p.cache)
    return np.asarray(R_paging.pack_slot(p.page_spec, cache, slot))


def _state_store_close(r, p):
    """Every stored snapshot of both Engines, leaf by leaf from its page
    bytes: positions exactly, K/V within BAR where valid, states within
    BAR everywhere."""
    spec = p.page_spec
    rslow, pslow = np.asarray(r.sessions.slow), p.sessions.slow.numpy()
    assert rslow.shape == pslow.shape
    names = [(st, b, k) for st in sorted(p.cache) for b in sorted(p.cache[st])
             for k in sorted(p.cache[st][b])]
    for idx in sorted(r.store_uid):
        rb, pb = rslow[idx].reshape(-1), pslow[idx].reshape(-1)
        views = {}
        for name, shape, dt, off in zip(names, spec.leaf_shapes,
                                        spec.leaf_dtypes, spec.leaf_offsets):
            npdt = np.int32 if dt == torch.int32 else np.float32
            n = math.prod(shape) * 4
            views[name] = (pb[off:off + n].view(npdt).reshape(shape),
                           rb[off:off + n].view(npdt).reshape(shape))
        for (st, b, k), (got, want) in views.items():
            if k == "pos":
                np.testing.assert_array_equal(got, want)
                continue
            pos = views.get((st, b, "pos"))
            if pos is not None:
                got, want = got[pos[1] < 2**30], want[pos[1] < 2**30]
            np.testing.assert_allclose(got, want, rtol=0, atol=BAR,
                                       err_msg=f"{idx}/{st}/{b}/{k}")


def test_engine_stream_with_waves_matches_reference(model):
    """Both Engines through one stream: exact-length prefills of four
    prompts, a suspend wave of two sessions, the rest drained, a resume
    wave; then the port's resumed tokens against its own uninterrupted
    run."""
    cfg, rparams, pparams = model
    kw = dict(slots=4, max_len=64, n_sessions=8)
    r, p = REngine(cfg, rparams, **kw), PEngine(cfg, pparams, device="cpu",
                                                **kw)
    assert not p._can_bucket and not r._can_bucket
    assert p.page_spec.leaf_shapes == r.page_spec.leaf_shapes
    assert p.page_spec.leaf_offsets == r.page_spec.leaf_offsets
    assert p._bucket_len(11) == 11
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 11, 17, 20)]
    reqs = []
    for uid, prompt in enumerate(prompts):
        rq, pq = RRequest(uid, prompt, 14), Request(uid, prompt, 14)
        assert r.submit(rq) == p.submit(pq)
        reqs.append((rq, pq))
    for _ in range(5):
        _step(r, p)
    packed = {p.active[s].uid: _pages_of(p, s) for s in (0, 2)}
    r.suspend_many([0, 2]), p.suspend_many([0, 2])
    for uid, pages in packed.items():
        np.testing.assert_array_equal(
            p.sessions.slow[p.forks.resolve(uid)].numpy(), pages)
    _state_store_close(r, p)
    _drain(r, p)
    r.resume_many([0, 2], [9, 9])
    back = {p.active[s].uid: p.active[s] for s in p.resume_many([0, 2],
                                                                [9, 9])}
    _drain(r, p)
    for rq, pq in reqs:
        assert pq.generated == rq.generated
    assert p.stats == r.stats and p.stats["resumes"] == 2
    assert p.session_pos == r.session_pos
    assert p.session_tok == r.session_tok
    _state_store_close(r, p)
    assert p.verify_failure_count() == r.verify_failure_count() == 0

    # suspended after 6 tokens, resumed for 9 (the first is the last one
    # emitted): 14 in all, the uninterrupted run's
    solo = PEngine(cfg, pparams, device="cpu", **kw)
    sreqs = [Request(uid, prompt, 14) for uid, prompt in enumerate(prompts)]
    for q in sreqs:
        solo.submit(q)
    while solo.active:
        solo.step()
    for (_, pq), sq in zip(reqs, sreqs):
        got = pq.generated + (back[pq.uid].generated[1:]
                              if pq.uid in back else [])
        assert got == sq.generated


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_agree(arch):
    argv = ["--arch", arch, "--reduced", "--requests", "4", "--resumes", "6"]
    want = r_main(argv)
    got = p_main(argv + ["--device", "cpu"])
    assert got["jobs_completed"] > 0 and got["resumes"] > 0
    assert ({k: v for k, v in got.items() if k not in WALL_CLOCK}
            == {k: v for k, v in want.items() if k not in WALL_CLOCK})
