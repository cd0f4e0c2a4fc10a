"""gemma3-27b's sliding-window path in the port against the reference, from
the reference's own weights (params_from_jax): ring-buffer cache lengths,
prefill logits and ring caches past the window, ragged decode across the
window, the Engine with suspend and resume waves of ring caches, and the
launcher's JSON.

Two reduced configs: ``get_reduced("gemma3-27b")`` (8 layers, window 16,
two periods of (L, L, L, G), no tail stage) and the same at 10 layers,
whose stage split adds the (L, L) tail stage that full-width gemma3 has.

Bound: f32 throughout at d_model 64, so the two frameworks differ only in
summation order, far below atol 1e-4 on O(1) logits and cache entries;
positions, tokens, stats, policy state and page bytes of positions are
exact.  Cache slots holding no token carry position 2**30, whose RoPE angle
the two frameworks round differently; they are never attended, so K/V are
compared at valid positions only."""
import dataclasses
import functools
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs import get_config, get_reduced
from repro.launch.serve import main as r_main
from repro.models import lm as R_lm
from repro.serve.engine import Engine as REngine
from repro.serve.engine import Request as RRequest
from repro_torch.configs import get_config as p_config
from repro_torch.configs import get_reduced as p_reduced
from repro_torch.launch.serve import main as p_main
from repro_torch.models import lm as P_lm
from repro_torch.serve.engine import Engine as PEngine
from repro_torch.serve.engine import Request
from repro_torch.weights import params_from_jax

ATOL, SLOTS, MAX_LEN = 1e-4, 4, 96
VARIANTS = {"8L": 8, "10L": 10}


def _cfg(variant):
    return dataclasses.replace(get_reduced("gemma3-27b"),
                               n_layers=VARIANTS[variant])


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(request):
    cfg = _cfg(request.param)
    rparams = R_lm.init_lm(cfg, jax.random.key(3))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    return cfg, rparams, pparams


def _blocks(cache):
    """(name, leaves) of every block of a cache, in the stage order."""
    for st in sorted(cache):
        for b in sorted(cache[st]):
            yield f"{st}/{b}", cache[st][b]


def _same_cache(pc, rc, atol=ATOL):
    pb, rb = dict(_blocks(pc)), dict(_blocks(rc))
    assert pb.keys() == rb.keys()
    for name, r in rb.items():
        p = {k: t.numpy() for k, t in pb[name].items()}
        r = {k: np.asarray(t) for k, t in r.items()}
        assert p.keys() == r.keys() == {"k", "v", "pos"}
        assert all(p[k].shape == r[k].shape for k in r), name
        np.testing.assert_array_equal(p["pos"], r["pos"], err_msg=name)
        valid = r["pos"] < 2**30
        for k in ("k", "v"):
            np.testing.assert_allclose(p[k][valid], r[k][valid], rtol=0,
                                       atol=atol, err_msg=f"{name}/{k}")


def _ring_blocks(cfg, cache):
    """The blocks of ``cache`` that are sliding-window rings."""
    kinds = [k for _, g in P_lm.stages_of(cfg) for k, _ in g]
    return [leaves for kind, (_, leaves) in zip(kinds, _blocks(cache))
            if kind == "attn_local"]


@functools.lru_cache(maxsize=None)
def _r_prefill(cfg):
    return jax.jit(partial(R_lm.prefill, cfg))


def _prefill_pair(cfg, rparams, pparams, prompt, pcache, slot):
    """Prefill ``prompt`` in both: the reference into a fresh batch-1 cache
    (the Engine's whole-slot insert), the port into ``pcache`` row
    ``slot``.  Returns (port logits, reference logits, reference cache)."""
    toks = jnp.asarray(prompt)[None]
    c1 = R_lm.init_cache(cfg, 1, max_len=MAX_LEN)
    rlog, c1 = _r_prefill(cfg)(rparams, toks, c1)
    P_lm.reset_slot(pcache, slot)
    plog, _ = P_lm.prefill(cfg, pparams, torch.from_numpy(prompt)[None],
                           pcache, slot=slot)
    return plog, rlog, c1


# ---- fault 1: a local layer's cache is a ring of min(max_len, window) ----

@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("max_len", [8, 96])
def test_ring_cache_lengths_match_reference(variant, max_len):
    cfg = _cfg(variant)
    want = jax.tree.map(lambda x: x.shape,
                        R_lm.init_cache(cfg, 3, max_len=max_len))
    got = P_lm.init_cache(cfg, 3, max_len, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), got) == want
    rings = _ring_blocks(cfg, got)
    assert rings and all(c["k"].shape[2] == min(max_len, cfg.window)
                         for c in rings)


def test_full_width_gemma3_cache_shapes_match_reference():
    """gemma3-27b at 14 layers and max_len 2048 (the card's run), shapes
    only: the reference through eval_shape, the port on the meta device."""
    cfg = dataclasses.replace(get_config("gemma3-27b"), n_layers=14)
    want = jax.eval_shape(lambda: R_lm.init_cache(cfg, 4, max_len=2048))
    got = P_lm.init_cache(dataclasses.replace(p_config("gemma3-27b"),
                                              n_layers=14), 4, 2048,
                          device="meta")
    assert (jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), got)
            == jax.tree.map(lambda s: (s.shape, f"torch.{s.dtype}"), want))
    assert [(r, len(g)) for r, g in P_lm.stages_of(cfg)] == [(2, 6), (1, 2)]
    assert sorted({c["k"].shape[2] for _, c in _blocks(got)}) == [1024, 2048]


# ---- fault 3: a prefill longer than the ring keeps its rolled tail -------

@pytest.mark.parametrize("n", [16, 23, 40])
def test_prefill_rolls_ring_tail(models, n):
    cfg, rparams, pparams = models
    prompt = np.random.default_rng(n).integers(
        0, cfg.vocab_size, n).astype(np.int32)
    pcache = P_lm.init_cache(cfg, 2, MAX_LEN, device="cpu")
    plog, rlog, rc = _prefill_pair(cfg, rparams, pparams, prompt, pcache, 1)
    np.testing.assert_allclose(plog[0].numpy(), np.asarray(rlog[0]), rtol=0,
                               atol=ATOL)
    L = cfg.window
    want = np.roll(np.arange(n)[-L:], (n - L) % L)     # token t in slot t % L
    for c in _ring_blocks(cfg, pcache):
        np.testing.assert_array_equal(c["pos"][:, 1].numpy(),
                                      np.broadcast_to(want, (c["pos"].shape[0],
                                                             L)))
        assert (c["pos"][:, 0] == 2**30).all()          # the other row
    one = jax.tree.map(lambda t: t[:, 1:2], pcache)
    _same_cache(one, rc)


# ---- the whole stack: prefill, then 48 ragged decode steps ----------------

def test_prefill_and_ragged_decode_past_window_match(models):
    """Fault 2 shows here first: decode writes slot ``pos % L`` of a ring,
    so every row crosses its window at least once in 48 steps."""
    cfg, rparams, pparams = models
    rng = np.random.default_rng(11)
    lens = (5, 12, 20, 33)          # two inside the window of 16, two past
    rcache = R_lm.init_cache(cfg, SLOTS, max_len=MAX_LEN)
    pcache = P_lm.init_cache(cfg, SLOTS, MAX_LEN, device="cpu")
    for s, n in enumerate(lens):
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        plog, rlog, c1 = _prefill_pair(cfg, rparams, pparams, prompt,
                                       pcache, s)
        np.testing.assert_allclose(plog[0].numpy(), np.asarray(rlog[0]),
                                   rtol=0, atol=ATOL)
        assert int(plog[0, -1].argmax()) == int(rlog[0, -1].argmax())
        rcache = jax.tree.map(
            lambda full, p: jax.lax.dynamic_update_slice_in_dim(
                full, p, s, axis=1), rcache, c1)
    _same_cache(pcache, rcache)

    r_decode = jax.jit(partial(R_lm.decode_step_batched, cfg))
    pos = np.array(lens, np.int32)
    for step in range(48):
        toks = rng.integers(0, cfg.vocab_size, SLOTS).astype(np.int32)
        active = np.ones(SLOTS, bool)
        if 10 <= step < 20:
            active[2] = False                 # slot 2 idles for 10 steps
        frozen = [c["k"][:, 2].clone() for c in _ring_blocks(cfg, pcache)]
        rn, rcache = r_decode(rparams, rcache, jnp.asarray(toks),
                              jnp.asarray(pos), jnp.asarray(active))
        pn, pcache = P_lm.decode_step_batched(
            cfg, pparams, pcache, torch.from_numpy(toks),
            torch.from_numpy(pos), active)
        np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
        if not active[2]:
            assert int(pn[2]) == -1
            assert all(torch.equal(c["k"][:, 2], f) for c, f in
                       zip(_ring_blocks(cfg, pcache), frozen))
        pos = pos + active
    _same_cache(pcache, rcache)
    assert (pos > cfg.window + 16).all()


# ---- fault 2 in isolation: the decode write slot is pos % L -------------

def test_decode_writes_ring_slot_pos_mod_window(models):
    cfg, _, pparams = models
    L = cfg.window
    pcache = P_lm.init_cache(cfg, 2, MAX_LEN, device="cpu")
    prompt = np.arange(1, L - 2, dtype=np.int32)
    P_lm.prefill(cfg, pparams, torch.from_numpy(prompt)[None], pcache,
                 slot=0)
    pos = np.array([len(prompt), 0], np.int32)
    for _ in range(L + 5):                   # wraps the ring once
        P_lm.decode_step_batched(cfg, pparams, pcache,
                                 torch.zeros(2, dtype=torch.int32),
                                 torch.from_numpy(pos), [True, False])
        pos[0] += 1
    last = np.arange(pos[0] - L, pos[0])
    for c in _ring_blocks(cfg, pcache):
        np.testing.assert_array_equal(
            c["pos"][:, 0].numpy(),
            np.broadcast_to(np.roll(last, pos[0] % L), c["pos"][:, 0].shape))
        assert (c["pos"][:, 1] == 2**30).all()


# ---- the Engine: suspend and resume waves of ring caches ---------------

KW = dict(slots=4, max_len=64, n_sessions=8)


def _same_store(r, p):
    """Every live snapshot row, leaf by leaf: positions exact, K/V at
    valid positions within ATOL."""
    spec = p.page_spec
    rslow, pslow = np.asarray(r.sessions.slow), p.sessions.slow.numpy()
    leaves = list(zip(spec.leaf_shapes, spec.leaf_dtypes, spec.leaf_offsets))
    assert len(leaves) % 3 == 0
    for idx in sorted(r.store_uid):
        rb, pb = rslow[idx].reshape(-1), pslow[idx].reshape(-1)
        view = lambda buf, shape, dt, off: buf[      # noqa: E731
            off:off + math.prod(shape) * 4].view(
                np.float32 if dt == torch.float32 else np.int32).reshape(shape)
        for j in range(0, len(leaves), 3):           # k, pos, v of a block
            (rk, pk), (rpos, ppos), (rv, pv) = (
                (view(rb, *leaves[j + i]), view(pb, *leaves[j + i]))
                for i in range(3))
            np.testing.assert_array_equal(ppos, rpos)
            valid = rpos < 2**30
            np.testing.assert_allclose(pk[valid], rk[valid], rtol=0,
                                       atol=ATOL)
            np.testing.assert_allclose(pv[valid], rv[valid], rtol=0,
                                       atol=ATOL)


def _same_engines(r, p):
    assert p.stats == r.stats
    assert p.session_pos == r.session_pos
    assert p.session_tok == r.session_tok
    assert p.store_uid == r.store_uid
    assert list(p.pos) == list(r.pos)
    rs, ps = r.sessions, p.sessions
    for name in ("counters", "hot", "tags", "benefit", "tick"):
        np.testing.assert_array_equal(getattr(ps.policy, name).numpy(),
                                      np.asarray(getattr(rs.policy, name)))
    assert (int(ps.hits), int(ps.accesses)) == (int(rs.hits), int(rs.accesses))
    assert p.fast_resident_uids() == r.fast_resident_uids()
    _same_store(r, p)


def _drain(r, p):
    while r.active:
        rc, pc = r.step(), p.step()
        assert [(s, q.uid, q.generated) for s, q in rc] == \
            [(s, q.uid, q.generated) for s, q in pc]
    assert not p.active


def test_engine_waves_of_ring_caches_match_reference(models):
    cfg, rparams, pparams = models
    r = REngine(cfg, rparams, **KW)
    p = PEngine(cfg, pparams, device="cpu", **KW)
    assert not p._can_bucket and p._bucket_len(23) == 23
    rng = np.random.default_rng(12)
    reqs = []
    for uid, (n, max_new) in enumerate([(6, 30), (20, 12), (9, 30),
                                        (23, 12)]):
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        rq, pq = RRequest(uid, prompt, max_new), Request(uid, prompt, max_new)
        assert r.submit(rq) == p.submit(pq)
        reqs.append((rq, pq))
    for _ in range(5):
        r.step(), p.step()
    r.suspend_many([0, 2]), p.suspend_many([0, 2])   # a wave past no window
    _same_engines(r, p)
    _drain(r, p)                     # uids 1 and 3 finish together: a wave
    r.resume_many([0, 2], [26, 26]), p.resume_many([0, 2], [26, 26])
    _drain(r, p)                     # both cross the window after resuming
    for rq, pq in reqs:
        assert pq.generated == rq.generated
    assert p.stats["suspends"] == 6 and p.stats["resumes"] == 2
    _same_engines(r, p)
    for uid in (1, 3, 0):            # single resumes reach the fast tier
        for e in (r, p):
            e.resume(uid, 3)
        _drain(r, p)
    _same_engines(r, p)
    assert p.verify_failure_count() == r.verify_failure_count() == 0
    assert int(p.verify_store()) == int(r.verify_store()) == 0


# ---- the launcher -------------------------------------------------------

WALL_CLOCK = ("tokens_per_s", "seconds", "decode_compile_count")


@pytest.mark.parametrize("extra", [[], ["--fork-prefix", "24"]],
                         ids=["plain", "fork-past-window"])
def test_launcher_json_matches_reference(extra):
    """The fork prefix (24) is longer than the reduced window (16): the
    template's ring is rolled, and every child resumes from it."""
    argv = ["--arch", "gemma3-27b", "--reduced", "--max-new", "24"] + extra
    want = r_main(argv)
    got = p_main(argv + ["--device", "cpu"])
    assert ({k: v for k, v in got.items() if k not in WALL_CLOCK}
            == {k: v for k, v in want.items() if k not in WALL_CLOCK})
    assert got["jobs_completed"] > 0 and got["decoded_tokens"] > 0


@pytest.mark.parametrize("arch,ported", [
    ("gemma3-27b", True), ("tinyllama-1.1b", True), ("gemma-7b", True),
    ("qwen1.5-110b", True), ("deepseek-v2-236b", True),
    ("jamba-v0.1-52b", True), ("rwkv6-7b", True), ("olmoe-1b-7b", True),
    ("seamless-m4t-medium", True), ("qwen2-vl-72b", True)])
def test_check_supported_takes_local_attention_only(arch, ported):
    """Every config in configs/ is ported (the refusal this test held is
    gone with its last two families): init_lm, init_cache and a forward
    of the reduced config run, local attention's ring caches among them."""
    cfg = p_reduced(arch)
    assert ported
    params = P_lm.init_lm(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    cache = P_lm.init_cache(cfg, 1, 8, device="cpu", enc_len=3)
    toks = torch.zeros((1, 4), dtype=torch.long)
    frames = (torch.zeros((1, 3, cfg.d_model)) if cfg.encdec else None)
    logits, _ = P_lm.prefill(cfg, params, toks, cache, enc_embeds=frames)
    assert logits.shape == (1, 4, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
