"""The other two dense archs the port runs, gemma-7b (GeGLU, tied
embeddings, MHA, head dim 256 at full width) and qwen1.5-110b (QKV bias,
GQA), against the reference from its own weights (params_from_jax): prefill
logits and caches, 48 teacher-forced ragged decode steps, and an Engine
stream with a suspend and a resume wave.  And the attention kernel's plain
twin at head dim 256, which reduced gemma-7b (head dim 32) does not reach,
against the reference's ``chunked_attention`` and its Pallas
``flash_attention`` (interpret mode, as tests/test_kernels.py runs it).

Bound: f32 throughout, so the two frameworks differ only in summation
order: atol 1e-4 on O(1) logits and cache entries (tests/test_torch_lm.py's
bar), greedy tokens equal, and the kernel tests' 3e-5 on attention outputs.
Cache slots holding no token carry position 2**30, whose RoPE angle the two
frameworks round differently; they are never attended, so caches are
compared at valid positions only."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.kernels import ops as R_ops
from repro.models import attention as RA
from repro.models import lm as R_lm
from repro.serve.engine import Engine as REngine
from repro.serve.engine import Request as RRequest
from repro_torch.kernels import ops as P_ops
from repro_torch.kernels import ref as P_ref
from repro_torch.models import lm as P_lm
from repro_torch.serve.engine import Engine as PEngine
from repro_torch.serve.engine import Request
from repro_torch.weights import params_from_jax

ATOL, SLOTS, MAX_LEN, STEPS = 1e-4, 4, 96, 48
PROMPTS = (6, 9, 12, 15)
# reduced gemma-7b (head dim 32), the same at gemma-7b's head dim 256, and
# reduced qwen1.5-110b
VARIANTS = {
    "gemma-7b": lambda: get_reduced("gemma-7b"),
    "gemma-7b-hd256": lambda: dataclasses.replace(get_reduced("gemma-7b"),
                                                  head_dim=256),
    "qwen1.5-110b": lambda: get_reduced("qwen1.5-110b"),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(request):
    cfg = VARIANTS[request.param]()
    rparams = R_lm.init_lm(cfg, jax.random.key(2))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    return cfg, rparams, pparams


def _blocks(cache):
    for st in sorted(cache):
        for b in sorted(cache[st]):
            yield f"{st}/{b}", cache[st][b]


def _same_cache(pc, rc, atol=ATOL):
    pb, rb = dict(_blocks(pc)), dict(_blocks(rc))
    assert pb.keys() == rb.keys()
    for name, r in rb.items():
        p = {k: t.numpy() for k, t in pb[name].items()}
        r = {k: np.asarray(t) for k, t in r.items()}
        np.testing.assert_array_equal(p["pos"], r["pos"], err_msg=name)
        valid = r["pos"] < 2**30
        for k in ("k", "v"):
            np.testing.assert_allclose(p[k][valid], r[k][valid], rtol=0,
                                       atol=atol, err_msg=f"{name}/{k}")


def _padded(prompt, lb=16):
    toks = np.zeros(lb, np.int32)
    toks[:len(prompt)] = prompt
    pos = np.full(lb, 2**30, np.int32)
    pos[:len(prompt)] = np.arange(len(prompt))
    return toks, pos


def test_config_shapes_match_reference(models):
    cfg, rparams, pparams = models
    assert P_lm.stages_of(cfg) == R_lm.stages_of(cfg)
    for path, leaf in jax.tree_util.tree_flatten_with_path(rparams)[0]:
        node = pparams
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype) == f"torch.{leaf.dtype}"
    assert ("bq" in pparams["stage0"]["b0"]["mixer"]) == cfg.qkv_bias
    assert ("head" not in pparams) == cfg.tie_embeddings


def test_prefill_and_ragged_decode_match(models):
    """Bucketed prefills (right-padded to 16 with 2**30 positions) into
    four rows, then 48 teacher-forced decode steps with one row idling for
    ten of them: logits and caches at 1e-4, greedy tokens equal."""
    cfg, rparams, pparams = models
    rng = np.random.default_rng(9)
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
    _same_cache(pcache, rcache)

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
    _same_cache(pcache, rcache)


def _step(r, p):
    assert [(s, q.uid, q.generated) for s, q in r.step()] == \
        [(s, q.uid, q.generated) for s, q in p.step()]


def _drain(r, p):
    while r.active:
        _step(r, p)
    assert not p.active


def test_engine_stream_with_waves_matches_reference(models):
    """The same requests through both Engines: bucketed prefills, a suspend
    wave of two sessions, the rest drained (finishers suspend as a wave),
    then a resume wave: tokens step by step, stats and session positions
    equal, no resume failing its checksums."""
    cfg, rparams, pparams = models
    kw = dict(slots=SLOTS, max_len=64, n_sessions=8)
    r, p = REngine(cfg, rparams, **kw), PEngine(cfg, pparams, device="cpu",
                                                **kw)
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
    _drain(r, p)
    r.resume_many([0, 2], [9, 9]), p.resume_many([0, 2], [9, 9])
    _drain(r, p)
    for rq, pq in reqs:
        assert pq.generated == rq.generated
    assert p.stats == r.stats and p.stats["resumes"] == 2
    assert p.session_pos == r.session_pos
    assert p.verify_failure_count() == r.verify_failure_count() == 0
    assert int(p.verify_store()) == 0


# ---- the attention twin at head dim 256 ----------------------------------

def _pair(x, name):
    t = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, name))
    return jnp.asarray(t.float().numpy()).astype(jnp.dtype(name)), t


def _err(p, r):
    return float(np.abs(p.float().numpy()
                        - np.asarray(r.astype(jnp.float32))).max())


TOL = {"float32": 3e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("B,S,H,K,T,window,dt", [
    (2, 1, 4, 4, 70, 0, "float32"),        # decode, MHA (gemma-7b's G = 1)
    (2, 1, 8, 2, 70, 20, "float32"),       # decode, G = 4, a window
    (2, 24, 4, 4, 24, 0, "float32"),       # prefill
    (1, 40, 4, 2, 40, 16, "float32"),      # prefill past a window
    (2, 1, 4, 4, 70, 0, "bfloat16"),
    (2, 24, 4, 2, 24, 0, "bfloat16"),
])
def test_head_dim_256_matches_reference(B, S, H, K, T, window, dt):
    """The plain chunked twin (what the card's kernel is held to) and the
    split-KV decode twin at head dim 256 against the reference's
    chunked_attention with ragged positions and a row with no valid key,
    and the twin's flash_attention against the Pallas kernel."""
    D = 256
    rng = np.random.default_rng(B * S + T + window)
    rq, q = _pair(rng.standard_normal((B, S, H, D)), dt)
    rk, k = _pair(rng.standard_normal((B, T, K, D)), dt)
    rv, v = _pair(rng.standard_normal((B, T, K, D)), dt)
    kv_pos = np.full((B, T), 2**30, np.int32)
    q_pos = np.zeros((B, S), np.int32)
    for b in range(B):
        n = int(rng.integers(S, T + 1))
        kv_pos[b, :n] = np.arange(n)
        q_pos[b] = np.arange(n - S, n)
    q_pos[0, 0] = -1                          # no valid key: exactly 0
    qp, kp = torch.from_numpy(q_pos), torch.from_numpy(kv_pos)
    want = RA.chunked_attention(rq, rk, rv, jnp.asarray(q_pos),
                                jnp.asarray(kv_pos), window=window, block=32)
    got = P_ops.chunked_attention(q, k, v, qp, kp, window=window, block=32)
    assert got.dtype == q.dtype and _err(got, want) < TOL[dt]
    assert not got[0, 0].float().any()
    if S == 1:
        twin = P_ref.split_decode_ref(q, k, v, qp, kp, n_split=3,
                                      split_len=32, window=window)
        assert _err(twin, want) < TOL[dt]
    pal = R_ops.flash_attention(jnp.swapaxes(rq, 1, 2),
                                jnp.swapaxes(rk, 1, 2),
                                jnp.swapaxes(rv, 1, 2), window=window,
                                block_q=16, block_k=16)
    mine = P_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), window=window)
    assert _err(mine, pal) < TOL[dt]
