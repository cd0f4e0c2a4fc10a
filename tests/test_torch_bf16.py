"""bf16 weights over the Engine's f32 cache, and the two repairs that path
needed.

- F2: ``params_from_jax`` carries the reference's bf16 leaves across bit for
  bit (numpy's bf16 comes from ``ml_dtypes``, which torch cannot read).
- F1: ``lm.init_cache`` takes float32, bfloat16 and int8 caches only (the
  int8 one with the reference's scale leaves, whose layout is pinned
  here; its values are tests/test_torch_int8.py's).
- The attention twin with q and k/v of different dtypes (bf16 q over an f32
  cache, and f32 q over a bf16 cache) against the reference's
  ``chunked_attention``, which promotes inside the kernel region, and its
  Pallas ``flash_attention`` (interpret mode): 3e-5 where the output (q's
  dtype) is f32, 2e-2 where it is bf16, the kernel tests' bars.
- Reduced gemma3-27b and tinyllama with the reference's bf16 weights:
  prefill into an f32 cache, then teacher-forced ragged decode, where the
  port's attention runs bf16 q over the f32 cache (the card's mixed route).

The model-level bar.  The port's greedy tokens equal the jitted
reference's, but at a tie: a token whose reference logit lies within 2
bf16 ulps of the top one.  In bf16 the reference's own numbers depend on
how XLA compiles it: jitted, XLA fuses elementwise chains and keeps some
intermediates in f32, while run op by op (``jax.disable_jit``) it rounds to
bf16 after every primitive, and the two runs pick different greedy tokens
at such ties; the port, whose torch ops round at yet other points, may
too, and the test prints how often it did.  Logits are held to 4 bf16 ulps of their largest magnitude, which the
reference's two runs meet too; the f32 cache's K/V, which hold bf16
values, to 8 ulps of each leaf's largest (the reference's two runs differ
by up to 4 there).
"""
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs import get_reduced
from repro.kernels import ops as R_ops
from repro.models import attention as RA
from repro.models import layers as R_layers
from repro.models import lm as R_lm
from repro.serve.engine import Engine as REngine
from repro.serve.engine import Request as RRequest
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as P_ops
from repro_torch.kernels import ref as P_ref
from repro_torch.models import lm as P_lm
from repro_torch.serve.engine import Engine as PEngine
from repro_torch.serve.engine import Request
from repro_torch.weights import params_from_jax

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
LOGIT_ULPS, KV_ULPS = 4, 8       # the model-level bars, in bf16 ulps


# ---- F2: bf16 leaves cross bit for bit ------------------------------------

def _u16(x):
    return np.asarray(x).view(np.uint16)


def test_params_from_jax_carries_bf16_bit_exactly():
    cfg = get_reduced("gemma3-27b")
    rparams = R_lm.init_lm(cfg, jax.random.key(1), dtype=jnp.bfloat16)
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    n_bf16 = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(rparams)[0]:
        node = pparams
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        if leaf.dtype == jnp.bfloat16:
            n_bf16 += 1
            assert node.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                node.view(torch.int16).numpy().view(np.uint16), _u16(leaf))
        else:                                # the norms stay f32
            assert node.dtype == torch.float32
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert n_bf16 > 0


def test_params_from_jax_keeps_special_bf16_values():
    """NaN, infinities, signed zero, the smallest subnormal and the
    largest finite value keep their bits."""
    special = jnp.array([jnp.nan, jnp.inf, -jnp.inf, -0.0, 0.0, 1.0,
                         9.2e-41, 3.3895e38, -1.5], jnp.bfloat16)
    got = params_from_jax({"w": np.asarray(special)}, device="cpu")["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16), _u16(special))


# ---- F1: a cache holds float32, bfloat16 or int8 with its scales ----------

@pytest.mark.parametrize("dtype", [torch.uint8, torch.float16, torch.int32])
def test_init_cache_refuses_other_dtypes(dtype):
    cfg = get_reduced("tinyllama-1.1b")
    with pytest.raises(NotImplementedError, match="Queue 3 F1"):
        P_lm.init_cache(cfg, 2, 16, dtype=dtype, device="cpu")


@pytest.mark.parametrize("arch", ["gemma3-27b", "deepseek-v2-236b"])
def test_init_cache_int8_leaves_match_reference(arch):
    """An int8 cache has the reference's leaves: int8 K/V (or MLA latent
    and shared key), f32 scales per token and kv head (per token for MLA)
    and int32 positions, in its shapes and values."""
    cfg = get_reduced(arch)
    cache = P_lm.init_cache(cfg, 2, 24, dtype=torch.int8, device="cpu")
    want = R_lm.init_cache(cfg, 2, max_len=24, dtype=jnp.int8)
    assert sorted(cache) == sorted(want)
    n_scales = 0
    for st in want:
        assert sorted(cache[st]) == sorted(want[st])
        for b in want[st]:
            assert sorted(cache[st][b]) == sorted(want[st][b])
            for name, r in want[st][b].items():
                p = cache[st][b][name]
                assert tuple(p.shape) == r.shape
                assert str(p.dtype) == f"torch.{r.dtype}"
                np.testing.assert_array_equal(p.numpy(), np.asarray(r))
                n_scales += name.endswith("_scale")
    assert n_scales > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_cache_takes_float_caches(dtype):
    cfg = get_reduced("gemma3-27b")
    cache = P_lm.init_cache(cfg, 2, 16, dtype=dtype, device="cpu")
    want = R_lm.init_cache(cfg, 2, max_len=16,
                           dtype=jnp.dtype(str(dtype).removeprefix("torch.")))
    for st in want:
        for b in want[st]:
            for name in ("k", "v", "pos"):
                p, r = cache[st][b][name], want[st][b][name]
                assert tuple(p.shape) == r.shape
                assert str(p.dtype) == f"torch.{r.dtype}"


# ---- the attention twin over mixed q/k/v dtypes -------------------------

def _pair(x, name):
    t = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, name))
    return jnp.asarray(t.float().numpy()).astype(jnp.dtype(name)), t


def _err(p, r):
    return float(np.abs(p.float().numpy()
                        - np.asarray(r.astype(jnp.float32))).max())


@pytest.mark.parametrize("B,S,H,K,T,D,window,qdt,kvdt", [
    (3, 1, 8, 2, 40, 16, 0, "bfloat16", "float32"),     # decode
    (3, 1, 8, 2, 40, 16, 0, "float32", "bfloat16"),
    (2, 1, 4, 2, 60, 32, 12, "bfloat16", "float32"),    # a window
    (2, 16, 4, 2, 16, 16, 0, "bfloat16", "float32"),    # prefill
    (2, 16, 4, 2, 16, 16, 0, "float32", "bfloat16"),
    (2, 9, 4, 1, 37, 32, 10, "bfloat16", "float32"),    # ragged T, window
    (2, 1, 4, 4, 50, 256, 0, "bfloat16", "float32"),    # head dim 256
    (2, 12, 4, 2, 12, 256, 0, "float32", "bfloat16"),
])
def test_mixed_dtype_attention_matches_reference(B, S, H, K, T, D, window,
                                                 qdt, kvdt):
    """q in one dtype, k/v in the other: the port's plain twin (and, for
    S = 1, the split-KV twin) against the reference's chunked_attention,
    which scales q in its own dtype, promotes to f32 and writes q's dtype,
    with ragged positions and a row with no valid key; and the twin's
    flash_attention against the Pallas kernel."""
    rng = np.random.default_rng(B * T + D + window)
    rq, q = _pair(rng.standard_normal((B, S, H, D)), qdt)
    rk, k = _pair(rng.standard_normal((B, T, K, D)), kvdt)
    rv, v = _pair(rng.standard_normal((B, T, K, D)), kvdt)
    kv_pos = np.full((B, T), 2**30, np.int32)
    q_pos = np.zeros((B, S), np.int32)
    for b in range(B):
        n = int(rng.integers(S, T + 1))
        kv_pos[b, :n] = np.arange(n)
        q_pos[b] = np.arange(n - S, n)
    q_pos[0, 0] = -1                          # no valid key: exactly 0
    qp, kp = torch.from_numpy(q_pos), torch.from_numpy(kv_pos)
    want = RA.chunked_attention(rq, rk, rv, jnp.asarray(q_pos),
                                jnp.asarray(kv_pos), window=window, block=16)
    assert want.dtype == jnp.dtype(qdt)
    got = P_ops.chunked_attention(q, k, v, qp, kp, window=window, block=16)
    assert got.dtype == q.dtype
    assert _err(got, want) < TOL[qdt]
    assert not got[0, 0].float().any()
    if S == 1:
        twin = P_ref.split_decode_ref(q, k, v, qp, kp, n_split=-(-T // 16),
                                      split_len=16, window=window)
        assert twin.dtype == q.dtype and _err(twin, want) < TOL[qdt]
    pal = R_ops.flash_attention(jnp.swapaxes(rq, 1, 2),
                                jnp.swapaxes(rk, 1, 2),
                                jnp.swapaxes(rv, 1, 2), window=window,
                                block_q=16, block_k=16)
    mine = P_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), window=window)
    assert mine.dtype == q.dtype and _err(mine, pal) < TOL[qdt]


def test_bf16_ulp_is_the_spacing_of_bf16():
    x = torch.tensor([1.0, 1.5, 2.0, 3.9, 0.04, -0.04, 0.0, 2.0**-130])
    got = P_ref.bf16_ulp(x)
    want = torch.tensor([2.0**-7, 2.0**-7, 2.0**-6, 2.0**-6, 2.0**-12,
                         2.0**-12, 0.0, 2.0**-137])
    assert torch.equal(got, want)
    up = x[:6].bfloat16().view(torch.int16) + 1        # the next bf16 up
    step = (up.view(torch.bfloat16).float() - x[:6].bfloat16().float()).abs()
    assert torch.equal(step, got[:6])


@pytest.mark.parametrize("qdt,kvdt,S", [
    ("bfloat16", "float32", 1), ("bfloat16", "bfloat16", 1),
    ("bfloat16", "bfloat16", 64), ("bfloat16", "float32", 64),
    ("float32", "bfloat16", 1)])
def test_attention_bar_takes_the_twin_and_fails_a_dropped_split(qdt, kvdt,
                                                                S):
    """The card's bar (``ref.attention_bar``) at gemma3's head dim over a
    1024-slot cache: the split-KV twin and the 3xTF32 emulation of the
    prefill kernel (its f32 path) meet it, and the same attention with one
    16-slot split of keys left out does not."""
    B, H, K, T, D = 2, 8, 4, 1024, 128
    g = torch.Generator().manual_seed(11)
    q = torch.randn((B, S, H, D), generator=g).to(getattr(torch, qdt))
    k = torch.randn((B, T, K, D), generator=g).to(getattr(torch, kvdt))
    v = torch.randn((B, T, K, D), generator=g).to(getattr(torch, kvdt))
    kp = torch.arange(T, dtype=torch.int32).expand(B, T).contiguous()
    qp = (torch.arange(S, dtype=torch.int32) + (T - S)).expand(B, S)
    want = P_ref.chunked_attention_ref(q, k, v, qp, kp)
    if S == 1:
        twin = P_ref.split_decode_ref(q, k, v, qp, kp, n_split=T // 64,
                                      split_len=64)
    else:             # q scaled in its own dtype first, as the kernel does
        qs = (q * D ** -0.5).float() * D ** 0.5
        plan = FA.prefill_plan(B, S, H, K, D, torch.float32 in (q.dtype,
                                                                 k.dtype), D)
        twin = P_ref.prefill_tc_ref(qs, k.float(), v.float(), qp, kp,
                                    keys=plan.keys).to(q.dtype)
    bar = P_ref.attention_bar(twin, want, q, k, v, qp, kp)
    assert bool(((twin.float() - want.float()).abs() < bar).all())
    dropped = kp.clone()
    dropped[:, 512:528] = 2**30
    wrong = P_ref.chunked_attention_ref(q, k, v, qp, dropped)
    bar = P_ref.attention_bar(wrong, want, q, k, v, qp, kp)
    assert not bool(((wrong.float() - want.float()).abs() < bar).all())


# ---- reduced models with bf16 weights over the f32 cache -----------------

SLOTS, MAX_LEN, STEPS = 4, 96, 24
PROMPTS = (5, 12, 20, 33)         # gemma3's reduced window is 16


def _r_decode_logits(cfg, params, cache, tokens, pos, active):
    """The reference's decode_step_batched (src/repro/models/lm.py:448-483)
    up to its last-position logits, and the cache it leaves."""
    B = tokens.shape[0]
    x = R_layers.embed(params["embed"], tokens[:, None]) * math.sqrt(
        cfg.d_model)
    new = {}
    for i, (reps, group) in enumerate(R_lm.stages_of(cfg)):
        x, _, new[f"stage{i}"] = R_lm._run_stage(
            cfg, reps, group, params[f"stage{i}"], x, pos[:, None], "decode",
            cache[f"stage{i}"], pos, None, 0)
    x = R_layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = R_layers.unembed(
        params["embed"] if cfg.tie_embeddings else params["head"], x,
        tied=cfg.tie_embeddings)
    keep = lambda o, n: jnp.where(                  # noqa: E731
        active.reshape((1, B) + (1,) * (n.ndim - 2)), n, o)
    return logits[:, -1], jax.tree.map(keep, cache, new)


def _r_prefill_row(cfg, params, prompt, cache, slot):
    """The reference prefills a bf16 batch-1 cache (its prefill into an f32
    one raises: lax.dynamic_update_slice takes one dtype) and the Engine's
    insert casts it into the f32 cache (serve/engine.py:213-216)."""
    c1 = R_lm.init_cache(cfg, 1, max_len=MAX_LEN, dtype=jnp.bfloat16)
    logits, c1 = R_lm.prefill(cfg, params, jnp.asarray(prompt)[None], c1)
    cache = jax.tree.map(lambda full, p: jax.lax.dynamic_update_slice_in_dim(
        full, p.astype(full.dtype), slot, axis=1), cache, c1)
    return logits[0], cache


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("arch", ["gemma3-27b", "tinyllama-1.1b"])
def test_bf16_weights_over_f32_cache_match_reference(arch, monkeypatch):
    """Prefill of four prompts (two past gemma3's window) and 24
    teacher-forced ragged decode steps, one row idling for eight: the
    port's greedy tokens equal the jitted reference's but at ties (within
    2 ulps of the top logit), at most one in 20; the port's bf16 logits within LOGIT_ULPS
    bf16 ulps of the jitted reference's (as the op-by-op run's are); the
    cache f32, its K/V within KV_ULPS ulps of the reference's."""
    cfg = get_reduced(arch)
    rparams = R_lm.init_lm(cfg, jax.random.key(0), dtype=jnp.bfloat16)
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    seen = {}
    logits_fn = P_lm._logits

    def spy(cfg_, params_, x):                 # the port's decode logits
        seen["logits"] = out = logits_fn(cfg_, params_, x)
        return out

    monkeypatch.setattr(P_lm, "_logits", spy)
    r_prefill = jax.jit(partial(_r_prefill_row, cfg), static_argnums=3)
    r_decode = jax.jit(partial(_r_decode_logits, cfg))
    rng = np.random.default_rng(3)
    jit_c = R_lm.init_cache(cfg, SLOTS, max_len=MAX_LEN)
    eager_c = jit_c
    pcache = P_lm.init_cache(cfg, SLOTS, MAX_LEN, device="cpu")
    outs = []                                  # (jit, op by op, port) logits
    for s, n in enumerate(PROMPTS):
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        rl, jit_c = r_prefill(rparams, prompt, jit_c, s)
        with jax.disable_jit():
            el, eager_c = _r_prefill_row(cfg, rparams, prompt, eager_c, s)
        plog, _ = P_lm.prefill(cfg, pparams, torch.from_numpy(prompt)[None],
                               pcache, slot=s)
        assert plog.dtype == torch.bfloat16
        outs.append((_f32(rl), _f32(el), plog[0].float().numpy()))
    pos = np.array(PROMPTS, np.int32)
    for step in range(STEPS):
        toks = rng.integers(0, cfg.vocab_size, SLOTS).astype(np.int32)
        active = np.ones(SLOTS, bool)
        if 6 <= step < 14:
            active[2] = False
        args = (jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(active))
        rl, jit_c = r_decode(rparams, jit_c, *args)
        with jax.disable_jit():
            el, eager_c = _r_decode_logits(cfg, rparams, eager_c, *args)
        pn, pcache = P_lm.decode_step_batched(
            cfg, pparams, pcache, torch.from_numpy(toks),
            torch.from_numpy(pos), active)
        pl = seen["logits"][:, -1].float().numpy()
        np.testing.assert_array_equal(pn.numpy()[~active], -1)
        np.testing.assert_array_equal(pn.numpy()[active],
                                      pl[active].argmax(-1))
        outs.append((_f32(rl)[active], _f32(el)[active], pl[active]))
        pos = pos + active
    bar = LOGIT_ULPS * _ulp(max(float(np.abs(r).max()) for r, _, _ in outs))
    assert max(float(np.abs(e - r).max()) for r, e, _ in outs) <= bar
    assert max(float(np.abs(p - r).max()) for r, _, p in outs) <= bar
    # greedy tokens: the last prompt position of each prefill, every decode
    r, e, p = (np.concatenate([o[i][-1:] for o in outs[:len(PROMPTS)]]
                              + [o[i] for o in outs[len(PROMPTS):]])
               for i in range(3))
    tr, te, tp = r.argmax(-1), e.argmax(-1), p.argmax(-1)
    top = r.max(-1)
    tie = r[np.arange(tp.size), tp] >= top - 2 * _ulp(top)
    differ = np.flatnonzero(tp != tr)
    print(f"{arch}: the port's greedy token equals the jitted reference's "
          f"at {tp.size - differ.size} of {tp.size} (the op-by-op "
          f"reference's at {int((te == tr).sum())}); the others are ties "
          f"within 2 ulps of the top logit")
    np.testing.assert_array_equal(tp[~tie], tr[~tie])
    assert differ.size <= tp.size // 20
    for st in pcache:                          # the Engine's f32 cache
        for b in pcache[st]:
            rpos = np.asarray(jit_c[st][b]["pos"])
            np.testing.assert_array_equal(pcache[st][b]["pos"].numpy(), rpos)
            valid = rpos < 2**30
            for name in ("k", "v"):
                pk = pcache[st][b][name]
                assert pk.dtype == torch.float32
                pk = pk.numpy()[valid]
                rk = _f32(jit_c[st][b][name])[valid]
                assert float(np.abs(pk - rk).max()) <= KV_ULPS * _ulp(
                    float(np.abs(rk).max()))


def _ulp(x):
    """The spacing of bf16 numbers at |x| (``ref.bf16_ulp`` on numpy)."""
    return P_ref.bf16_ulp(torch.as_tensor(np.asarray(x, np.float32))).numpy()


@pytest.mark.parametrize("arch", ["gemma3-27b", "tinyllama-1.1b"])
def test_bf16_engine_waves_resume_the_uninterrupted_tokens(arch):
    """The port's Engine with bf16 weights (its cache f32, as the
    reference's): a suspend and a resume wave of sessions past gemma3's
    window give the tokens of the same requests decoded without a pause,
    and no resume fails its checksums.  The reference Engine cannot run
    this stream: its prefill of bf16 K/V into its f32 batch-1 cache raises
    (lax.dynamic_update_slice takes one dtype)."""
    cfg = get_reduced(arch)
    rparams = R_lm.init_lm(cfg, jax.random.key(0), dtype=jnp.bfloat16)
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 21, 30)]
    kw = dict(slots=3, max_len=64, n_sessions=8)
    with pytest.raises(TypeError, match="dtype"):
        REngine(cfg, rparams, **kw).submit(RRequest(0, prompts[0], 4))
    solo = PEngine(cfg, pparams, device="cpu", **kw)
    whole = [Request(uid, p, 20) for uid, p in enumerate(prompts)]
    for q in whole:
        solo.submit(q)
    while solo.active:
        solo.step()
    eng = PEngine(cfg, pparams, device="cpu", **kw)
    assert all(c["k"].dtype == torch.float32
               for st in eng.cache.values() for c in st.values())
    reqs = [Request(uid, p, 20) for uid, p in enumerate(prompts)]
    for q in reqs:
        eng.submit(q)
    for _ in range(7):
        eng.step()
    held = {s: eng.active[s] for s in (1, 2)}
    eng.suspend_many([1, 2])
    resumed = {}
    for s in eng.resume_many([held[1].uid, held[2].uid],
                             [20 - len(held[s].generated) + 1
                              for s in (1, 2)]):
        resumed[eng.active[s].uid] = eng.active[s]
    while eng.active:
        eng.step()
    for q, w in zip(reqs, whole):
        got = (q.generated + resumed[q.uid].generated[1:]
               if q.uid in resumed else q.generated)
        assert len(w.generated) == 20 and got == w.generated
    assert eng.verify_failure_count() == 0 and int(eng.verify_store()) == 0
