"""M-RoPE (qwen2-vl-72b) against the reference: ``apply_mrope`` with
distinct temporal/height/width ids and with equal ones (RoPE's values), the
GQA block under M-RoPE, and reduced qwen2-vl's ``forward`` over an image's
position ids, ``prefill`` (the cache holds the temporal ids), teacher-forced
``decode_step``/``decode_step_batched`` (one position broadcast to all
three ids), the Engine with a suspend and a resume wave, the Scheduler and
the launcher, from the reference's weights (``params_from_jax``), f32.

BAR is ROADMAP's f32 parity bar: the two frameworks compute the same f32
steps in another order of summation, a few 1e-6 at these widths.  Greedy
tokens must be equal.

An image is numbered as Qwen2-VL numbers one: after a text prefix of n
tokens (ids 0..n-1, all three equal) each patch (i, j) of an h x w grid
takes temporal id n, height id n + i and width id n + j, and the text
after it resumes at n + max(h, w), all three equal.  So the temporal ids
repeat over the image: every patch sees every other patch of its image."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro import sched as R
from repro.configs import get_reduced
from repro.launch.serve import main as r_main
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import lm as R_lm
from repro.serve.engine import Engine as REngine
from repro.serve.engine import Request as RRequest
from repro_torch import sched as P
from repro_torch.launch.serve import main as p_main
from repro_torch.models import attention as PA
from repro_torch.models import layers as PL
from repro_torch.models import lm as P_lm
from repro_torch.serve.engine import Engine as PEngine
from repro_torch.serve.engine import Request
from repro_torch.weights import params_from_jax

import _torch_families as FAM

BAR = 3e-5
ARCH = "qwen2-vl-72b"
WALL_CLOCK = ("tokens_per_s", "seconds", "decode_compile_count")


def vl_positions(prefix: int, grid_h: int, grid_w: int, suffix: int
                 ) -> np.ndarray:
    """(3, prefix + h*w + suffix) int32 ids of a text prefix, one image of
    an h x w patch grid and a text suffix, as Qwen2-VL numbers them."""
    ids = [np.tile(np.arange(prefix), (3, 1))]
    i, j = np.divmod(np.arange(grid_h * grid_w), grid_w)
    ids.append(np.stack([np.full_like(i, prefix), prefix + i, prefix + j]))
    start = prefix + max(grid_h, grid_w)
    ids.append(np.tile(np.arange(start, start + suffix), (3, 1)))
    return np.concatenate(ids, 1).astype(np.int32)


@pytest.fixture(scope="module")
def model():
    cfg = get_reduced(ARCH)
    rparams = R_lm.init_lm(cfg, jax.random.key(5))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    return cfg, rparams, pparams


def _close(p, r, bar=BAR, what=""):
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), rtol=0,
                               atol=bar, err_msg=what)


def _tokens(cfg, seed, S, batch=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, S)).astype(np.int32)


# ---- apply_mrope -----------------------------------------------------------

@pytest.mark.parametrize("D,theta", [(16, 1e6), (128, 1e6), (64, 1e4)])
def test_apply_mrope_distinct_ids_match_reference(D, theta):
    """Three independent id rows, up to 5000 (the angles the bands take
    differ), at the reduced and the full head dim."""
    rng = np.random.default_rng(D)
    x = rng.standard_normal((2, 9, 3, D)).astype(np.float32)
    pos = rng.integers(0, 5000, (3, 2, 9)).astype(np.int32)
    want = RL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = PL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, want, bar=1e-5)


def test_apply_mrope_sections_take_the_remainder():
    """At D 16 (8 bands) the sections (2, 1, 1) are 4, 2 and 2 bands; at D
    20 (10 bands) 5, 2 and 3: a row's id moves only its own bands."""
    for D, widths in ((16, (4, 2, 2)), (20, (5, 2, 3))):
        x = torch.ones((1, 1, 1, D))
        base = PL.apply_mrope(x, torch.zeros((3, 1, 1), dtype=torch.int32))
        moved = []
        for r in range(3):
            pos = torch.zeros((3, 1, 1), dtype=torch.int32)
            pos[r] = 7
            d = (PL.apply_mrope(x, pos) != base)[0, 0, 0, :D // 2]
            moved.append(int(d.sum()))
        assert tuple(moved) == widths


def test_apply_mrope_equal_ids_are_rope():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 7, 4, 128)).astype(
        np.float32))
    pos = torch.from_numpy(rng.integers(0, 3000, (2, 7)).astype(np.int32))
    got = PL.apply_mrope(x, pos.expand(3, 2, 7), 1e6)
    assert torch.equal(got, PL.apply_rope(x, pos, 1e6))
    _close(got, RL.apply_rope(jnp.asarray(x.numpy()),
                              jnp.asarray(pos.numpy()), 1e6), bar=1e-5)


def test_gqa_block_under_mrope_matches_reference(model):
    """No cache (causal over the temporal ids, repeated over an image)
    and a decode step over a cache written at those ids."""
    cfg, rparams, pparams = model
    pos = vl_positions(3, 4, 5, 6)[:, None].repeat(2, 1)      # (3, 2, 29)
    S = pos.shape[-1]
    x = np.random.default_rng(2).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    rp = jax.tree.map(lambda t: t[0], rparams["stage0"]["b0"]["mixer"])
    pp = {k: v[0] for k, v in pparams["stage0"]["b0"]["mixer"].items()}
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
              head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, mrope=True,
              block=cfg.attn_block)
    want, _ = RA.gqa_block(rp, jnp.asarray(x), jnp.asarray(pos), **kw)
    got, _ = PA.gqa_block(pp, torch.from_numpy(x), torch.from_numpy(pos),
                          **kw)
    _close(got, want)


# ---- the model -------------------------------------------------------------

def test_forward_with_image_positions_matches_reference(model):
    """Distinct t/h/w ids (a 6 x 5 image after 4 text tokens, 7 text
    tokens after it): logits within BAR, greedy tokens equal; and the
    ids matter (arange positions give other logits)."""
    cfg, rparams, pparams = model
    pos = vl_positions(4, 6, 5, 7)[:, None].repeat(2, 1)
    S = pos.shape[-1]
    toks = _tokens(cfg, 3, S)
    want, _, _ = R_lm.forward(cfg, rparams, jnp.asarray(toks),
                              positions=jnp.asarray(pos))
    got, _, _ = P_lm.forward(cfg, pparams, torch.from_numpy(toks),
                             positions=torch.from_numpy(pos))
    _close(got, want)
    np.testing.assert_array_equal(got.numpy().argmax(-1),
                                  np.asarray(want).argmax(-1))
    plain, _, _ = P_lm.forward(cfg, pparams, torch.from_numpy(toks))
    assert float((plain - got).abs().max()) > 1e-3


def test_prefill_writes_temporal_ids_and_decodes_as_reference(model):
    """prefill of an image prompt into a batch-1 cache: logits equal the
    cacheless forward's, the cache's positions are the temporal ids, and
    K/V and positions equal the reference's; then teacher-forced
    decode_steps past the image, each position broadcast to all three ids,
    against the reference's."""
    cfg, rparams, pparams = model
    pos = vl_positions(5, 4, 4, 3)[:, None]                  # (3, 1, 24)
    S, max_len = pos.shape[-1], 48
    toks = _tokens(cfg, 4, S + 8, batch=1)
    rc = R_lm.init_cache(cfg, 1, max_len=max_len)
    pc = P_lm.init_cache(cfg, 1, max_len, device="cpu")
    rlog, rc = R_lm.prefill(cfg, rparams, jnp.asarray(toks[:, :S]), rc,
                            positions=jnp.asarray(pos))
    plog, _ = P_lm.prefill(cfg, pparams, torch.from_numpy(toks[:, :S]), pc,
                           positions=torch.from_numpy(pos))
    _close(plog, rlog)
    full, _, _ = P_lm.forward(cfg, pparams, torch.from_numpy(toks[:, :S]),
                              positions=torch.from_numpy(pos))
    _close(plog, full.numpy(), bar=1e-6)
    FAM.same_cache(pc, rc, atol=BAR)
    for st in pc.values():
        for c in st.values():
            np.testing.assert_array_equal(c["pos"][:, 0, :S].numpy(),
                                          np.broadcast_to(pos[0], (
                                              c["pos"].shape[0], S)))
    r_step = jax.jit(partial(R_lm.decode_step, cfg))
    nxt = int(pos.max()) + 1
    for t in range(8):
        rlog, rc = r_step(rparams, rc, jnp.asarray(toks[:, S + t:S + t + 1]),
                          jnp.int32(nxt + t))
        plog, _ = P_lm.decode_step(cfg, pparams, pc,
                                   torch.from_numpy(toks[:, S + t:S + t + 1]),
                                   nxt + t)
        _close(plog, rlog, what=f"step {t}")
    FAM.same_cache(pc, rc, atol=BAR)


def test_prefill_and_ragged_decode_match_reference(model):
    """Exact-length text prefills (the Engine's: no buckets under M-RoPE)
    into four rows, then 24 ragged decode_step_batched steps with one row
    idle for eight: tokens equal, caches within BAR, the idle row
    bit-exact."""
    cfg, rparams, pparams = model
    slots, max_len = 4, 64
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 12, 15)]
    rc = R_lm.init_cache(cfg, slots, max_len=max_len)
    pc = P_lm.init_cache(cfg, slots, max_len, device="cpu")
    for s, p in enumerate(prompts):
        c1 = R_lm.init_cache(cfg, 1, max_len=max_len)
        rlog, c1 = R_lm.prefill(cfg, rparams, jnp.asarray(p)[None], c1)
        rc = jax.tree.map(lambda full, one: jax.lax.dynamic_update_slice_in_dim(
            full, one, s, axis=1), rc, c1)
        plog, _ = P_lm.prefill(cfg, pparams, torch.from_numpy(p)[None], pc,
                               slot=s)
        _close(plog, rlog)
    FAM.same_cache(pc, rc, atol=BAR)
    r_decode = jax.jit(partial(R_lm.decode_step_batched, cfg))
    pos = np.array([len(p) for p in prompts], np.int32)
    for step in range(24):
        toks = rng.integers(0, cfg.vocab_size, slots).astype(np.int32)
        active = np.ones(slots, bool)
        if 8 <= step < 16:
            active[2] = False
        frozen = pc["stage0"]["b0"]["k"][:, 2].clone()
        rn, rc = r_decode(rparams, rc, jnp.asarray(toks), jnp.asarray(pos),
                          jnp.asarray(active))
        pn, _ = P_lm.decode_step_batched(cfg, pparams, pc,
                                         torch.from_numpy(toks),
                                         torch.from_numpy(pos), active)
        np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
        if not active[2]:
            assert torch.equal(pc["stage0"]["b0"]["k"][:, 2], frozen)
        pos = pos + active
    FAM.same_cache(pc, rc, atol=BAR)


def test_params_from_jax_carries_qkv_biases(model):
    cfg, rparams, pparams = model
    # the reference inits the biases at 0: give them values to carry
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, rparams)
    mixer = tree["stage0"]["b0"]["mixer"]
    for name in ("bq", "bk", "bv"):
        mixer[name] = rng.standard_normal(mixer[name].shape).astype(
            np.float32)
    got = params_from_jax(tree, device="cpu")["stage0"]["b0"]["mixer"]
    for name in ("bq", "bk", "bv"):
        np.testing.assert_array_equal(got[name].numpy(), mixer[name])
    own = P_lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(rparams)[0]:
        for t in (pparams, own):
            node = t
            for k in path:
                node = node[k.key]
            assert tuple(node.shape) == leaf.shape
            assert str(node.dtype) == f"torch.{leaf.dtype}"


# ---- serving ---------------------------------------------------------------

def _step(r, p):
    assert [(s, q.uid, q.generated) for s, q in r.step()] == \
        [(s, q.uid, q.generated) for s, q in p.step()]


def _drain(r, p):
    while r.active:
        _step(r, p)
    assert not p.active


def test_engine_stream_with_waves_matches_reference(model):
    """Both Engines through one stream: exact-length prefills (no buckets
    under M-RoPE), a suspend wave of two sessions, the rest drained, a
    resume wave: tokens step by step, stats, sessions and the stored
    snapshots' page bytes equal; then the port's resumed tokens equal its
    own uninterrupted run."""
    cfg, rparams, pparams = model
    kw = dict(slots=4, max_len=64, n_sessions=8)
    r, p = REngine(cfg, rparams, **kw), PEngine(cfg, pparams, device="cpu",
                                                **kw)
    assert not p._can_bucket and not r._can_bucket
    assert p.page_spec.leaf_shapes == r.page_spec.leaf_shapes
    assert p.page_spec.leaf_offsets == r.page_spec.leaf_offsets
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
    r.suspend_many([0, 2]), p.suspend_many([0, 2])
    FAM._same_store(r, p)
    _drain(r, p)
    r.resume_many([0, 2], [9, 9])
    back = {p.active[s].uid: p.active[s]
            for s in p.resume_many([0, 2], [9, 9])}
    _drain(r, p)
    for rq, pq in reqs:
        assert pq.generated == rq.generated
    assert p.stats == r.stats and p.stats["resumes"] == 2
    assert p.session_pos == r.session_pos
    assert p.session_tok == r.session_tok
    FAM._same_store(r, p)
    assert p.verify_failure_count() == r.verify_failure_count() == 0
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


def _sched_run(pkg, model, policy):
    cfg, rparams, pparams = model
    wl = pkg.WorkloadConfig(n_fresh=4, n_followups=8, mean_gap_ns=1600.0,
                            arrival="bursty", burst=4, zipf_s=1.8,
                            think_ns=2000.0)
    arrivals = pkg.generate_workload(wl, seed=4, vocab_size=cfg.vocab_size)
    kw = dict(slots=2, max_len=96, n_sessions=pkg.n_sessions_for(wl))
    eng = (REngine(cfg, rparams, **kw) if pkg is R
           else PEngine(cfg, pparams, device="cpu", **kw))
    tokens = []
    step_end = eng.step_end

    def logged(handle):
        done = step_end(handle)
        tokens.extend((req.uid, list(req.generated)) for _, req in done)
        return done
    eng.step_end = logged
    s = pkg.Scheduler(eng, policy=policy, arrivals=arrivals)
    return s, eng, s.run(), tokens


@pytest.mark.parametrize("policy", ["fifo", "cost_aware"])
def test_scheduler_tokens_match_reference(model, policy):
    """Both Schedulers over a 2-slot Engine (so sessions suspend and
    resume): decisions, summaries, stats and every completed request's
    tokens equal."""
    rs, reng, rsum, rtok = _sched_run(R, model, policy)
    ps, peng, psum, ptok = _sched_run(P, model, policy)
    assert ([dataclasses.astuple(d) for d in ps.metrics.decisions]
            == [dataclasses.astuple(d) for d in rs.metrics.decisions])
    assert psum == rsum
    assert ptok == rtok and len(ptok) == 12
    assert peng.stats == reng.stats and peng.stats["resumes"] > 0


def test_launchers_agree():
    argv = ["--arch", ARCH, "--reduced", "--requests", "4", "--resumes", "6"]
    want = r_main(argv)
    got = p_main(argv + ["--device", "cpu"])
    assert got["jobs_completed"] > 0 and got["resumes"] > 0
    assert ({k: v for k, v in got.items() if k not in WALL_CLOCK}
            == {k: v for k, v in want.items() if k not in WALL_CLOCK})
