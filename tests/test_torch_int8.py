"""int8 KV caches against the reference (its ``tests/test_int8_kv.py``
path): quantise on write, dequantise in attention (K3d's plain version),
``lm.decode_step`` token by token from an empty cache.

- The quantiser (``attention.quantise``) on the reference's own K/V (GQA)
  and latent and shared key (MLA): the int8 bytes and the f32 scales the
  reference's decode writes into its cache, bit for bit.
- ``chunked_attention_ref`` with scales against the reference's
  ``chunked_attention`` within 3e-5 (the f32 kernel bar), blocks padded
  (scale 0, position 2**30) and windowed included; the split-KV twin
  against it.
- ``decode_step`` over int8 caches of reduced tinyllama, gemma3 (the ring
  wraps), MLA-only deepseek-v2 and olmoe: positions equal, scales within
  1e-5 relative (each is the max of K/V that agree to a few f32 ulps of
  the layers' drift: 1e-6 relative at most here), int8 codes off by at most one at no more than 0.1% of
  them (the K/V they quantise agree only to f32 rounding, and a code
  flips where that rounding straddles a half step: none did at these
  seeds), and the logits within LOGIT_BAR of the reference's.  With the
  codes equal, what differs is the f32 rounding around them, as on the
  float routes (1e-4, the dense families' bar, at logits of magnitude
  ~4).
- The reference's own bars hold for the port: relative error against the
  port's ``forward`` below 0.05, greedy agreement of int8 with f32 of at
  least 0.75 for MoE.
- A prefill into an int8 cache raises, in both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs import get_reduced
from repro.models import attention as R_att
from repro.models import lm as R_lm
from repro_torch.kernels import ref
from repro_torch.models import attention as P_att
from repro_torch.models import lm as P_lm
from repro_torch.weights import params_from_jax

LOGIT_BAR, F32_BAR = 1e-4, 3e-5


def _cfg(arch):
    cfg = get_reduced(arch)
    if arch == "deepseek-v2-236b":
        cfg = dataclasses.replace(cfg, n_experts=0, top_k=0,
                                  n_shared_experts=0)
    return cfg


def _both(cfg, seed=3):
    rparams = R_lm.init_lm(cfg, jax.random.key(seed))
    return rparams, params_from_jax(jax.tree.map(np.asarray, rparams),
                                    device="cpu")


# ---- the quantiser ---------------------------------------------------------

def _bits(p, r):
    np.testing.assert_array_equal(p.numpy().view(np.uint8),
                                  np.asarray(r).view(np.uint8))


def test_quantiser_bit_equal_on_reference_gqa_kv():
    """One reference GQA decode into an int8 cache; its new K/V (the
    reference's own roped projections) through the port's quantiser give
    the cache's int8 bytes and scales."""
    cfg = get_reduced("tinyllama-1.1b")
    B, T = 3, 8
    rp = R_att.init_gqa_params(jax.random.key(1), cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.head_dim)
    x = jnp.asarray(np.random.default_rng(2).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32) * 3)
    pos = jnp.full((B, 1), 5, jnp.int32)
    k = R_att.apply_rope((x @ rp["wk"]).reshape(B, 1, cfg.n_kv_heads,
                                                 cfg.head_dim), pos)
    v = (x @ rp["wv"]).reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
    z8 = jnp.zeros((B, T, cfg.n_kv_heads, cfg.head_dim), jnp.int8)
    zs = jnp.zeros((B, T, cfg.n_kv_heads), jnp.float32)
    _, (ck, cv, _, (ks, vs)) = R_att.gqa_block(
        rp, x, pos, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, kv_cache=(z8, z8, jnp.full((B, T), 2**30,
                                                           jnp.int32)),
        cache_index=jnp.int32(5), kv_scales=(zs, zs))
    for val, cq, cs in ((k, ck, ks), (v, cv, vs)):
        q8, s = P_att.quantise(torch.from_numpy(np.asarray(val)))
        _bits(q8[:, 0], cq[:, 5])
        _bits(s[:, 0], cs[:, 5])
        assert int(np.abs(np.asarray(cq[:, 5])).max()) == 127


def test_quantiser_bit_equal_on_reference_mla_latent():
    cfg = _cfg("deepseek-v2-236b")
    B, T = 2, 6
    rp = R_att.init_mla_params(jax.random.key(4), cfg.d_model, cfg.n_heads,
                               cfg.q_lora_rank, cfg.kv_lora_rank,
                               cfg.qk_nope_dim, cfg.qk_rope_dim,
                               cfg.v_head_dim)
    x = jnp.asarray(np.random.default_rng(5).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32))
    pos = jnp.full((B, 1), 2, jnp.int32)
    _, _, c_kv, k_rope = R_att._mla_qkr(rp, x, pos, cfg.n_heads,
                                        cfg.qk_nope_dim, cfg.qk_rope_dim,
                                        cfg.kv_lora_rank, cfg.rope_theta)
    cc = jnp.zeros((B, T, cfg.kv_lora_rank), jnp.int8)
    cr = jnp.zeros((B, T, cfg.qk_rope_dim), jnp.int8)
    z = jnp.zeros((B, T), jnp.float32)
    _, (cc, cr, _, (cs, rs)) = R_att.mla_block(
        rp, x, pos, n_heads=cfg.n_heads, q_lora=cfg.q_lora_rank,
        kv_lora=cfg.kv_lora_rank, qk_nope=cfg.qk_nope_dim,
        qk_rope=cfg.qk_rope_dim, v_dim=cfg.v_head_dim,
        rope_theta=cfg.rope_theta,
        kv_cache=(cc, cr, jnp.full((B, T), 2**30, jnp.int32)),
        cache_index=jnp.int32(2), kv_scales=(z, z))
    for val, cq, cscale in ((c_kv, cc, cs), (k_rope, cr, rs)):
        q8, s = P_att.quantise(torch.from_numpy(np.asarray(val)))
        _bits(q8[:, 0], cq[:, 2])
        _bits(s[:, 0], cscale[:, 2])


def test_quantiser_rounds_half_to_even_and_clips():
    """Values at exact halves of a step round to even, as jnp.round does;
    a zero row takes the 1e-6 floor of its scale."""
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -127.0],
                      [0.0] * 7])
    q8, s = P_att.quantise(x)
    r8 = jnp.clip(jnp.round(jnp.asarray(x.numpy()) / (np.maximum(
        np.abs(x.numpy()).max(-1), 1e-6) / 127.0)[:, None]), -127, 127)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(r8).astype(np.int8))
    assert q8[0].tolist() == [127, 0, 2, 2, 0, -2, -127]
    assert float(s[1]) == pytest.approx(1e-6 / 127)


# ---- the attention twin with scales ----------------------------------------

@pytest.mark.parametrize("B,S,T,H,K,D,window,block", [
    (2, 1, 40, 8, 2, 64, 0, 16),       # T not a multiple of the block
    (3, 1, 33, 4, 2, 32, 8, 32),       # window, one padded block
    (1, 5, 20, 4, 4, 16, 0, 8),        # S > 1 (the twin takes it)
])
def test_scaled_twin_matches_reference(B, S, T, H, K, D, window, block):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k8 = rng.integers(-127, 128, (B, T, K, D)).astype(np.int8)
    v8 = rng.integers(-127, 128, (B, T, K, D)).astype(np.int8)
    ks = rng.uniform(0.001, 0.05, (B, T, K)).astype(np.float32)
    vs = rng.uniform(0.001, 0.05, (B, T, K)).astype(np.float32)
    ks[0, 3] = 0.0                       # a zero scale: that key reads 0
    kv_pos = np.full((B, T), 2**30, np.int32)
    q_pos = np.zeros((B, S), np.int32)
    for b in range(B):
        n = T - 3 * b
        kv_pos[b, :n] = np.arange(n)
        q_pos[b] = np.arange(n - S, n)
    want = R_att.chunked_attention(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(q_pos),
        jnp.asarray(kv_pos), window=window, block=block,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    t = {n: torch.from_numpy(a) for n, a in dict(
        q=q, k=k8, v=v8, qp=q_pos, kp=kv_pos, ks=ks, vs=vs).items()}
    got = ref.chunked_attention_ref(t["q"], t["k"], t["v"], t["qp"], t["kp"],
                                    window=window, block=block,
                                    k_scale=t["ks"], v_scale=t["vs"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_BAR)
    if S == 1:
        split = ref.split_decode_ref(t["q"], t["k"], t["v"], t["qp"],
                                     t["kp"], n_split=3, split_len=16,
                                     window=window, k_scale=t["ks"],
                                     v_scale=t["vs"])
        np.testing.assert_allclose(split.numpy(), np.asarray(want), rtol=0,
                                   atol=F32_BAR)


def test_scaled_twin_refuses_missing_scales():
    q = torch.zeros(1, 1, 2, 16)
    k = torch.zeros(1, 4, 1, 16, dtype=torch.int8)
    p = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="k_scale"):
        ref.chunked_attention_ref(q, k, k, p[:, :1], p)
    with pytest.raises(ValueError, match="k_scale"):
        ref.chunked_attention_ref(q, k.float(), k.float(), p[:, :1], p,
                                  k_scale=torch.ones(1, 4, 1),
                                  v_scale=torch.ones(1, 4, 1))


# ---- the model -------------------------------------------------------------

def _decode(cfg, params, dtype, toks, max_len, port):
    B, S = toks.shape
    outs = []
    if port:
        cache = P_lm.init_cache(cfg, B, max_len, dtype=dtype, device="cpu")
        for t in range(S):
            lg, cache = P_lm.decode_step(
                cfg, params, cache, torch.from_numpy(toks[:, t:t + 1]), t)
            outs.append(lg[:, 0].numpy())
    else:
        cache = R_lm.init_cache(cfg, B, max_len=max_len, dtype=dtype)
        step = jax.jit(lambda p, c, tk, pos: R_lm.decode_step(cfg, p, c, tk,
                                                               pos))
        for t in range(S):
            lg, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
            outs.append(np.asarray(lg[:, 0]))
    return np.stack(outs, 1), cache


@pytest.mark.parametrize("arch,S,max_len", [
    ("tinyllama-1.1b", 8, 16),
    ("gemma3-27b", 40, 48),            # window 16: the ring wraps twice
    ("deepseek-v2-236b", 8, 16),       # MLA only
    ("olmoe-1b-7b", 8, 16),
])
def test_int8_decode_step_matches_reference(arch, S, max_len):
    cfg = _cfg(arch)
    rparams, pparams = _both(cfg)
    toks = np.asarray(jax.random.randint(jax.random.key(4), (2, S), 0,
                                         cfg.vocab_size))
    want, rc = _decode(cfg, rparams, jnp.int8, toks, max_len, port=False)
    got, pc = _decode(cfg, pparams, torch.int8, toks, max_len, port=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_BAR)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    codes = flips = 0
    for st in rc:
        for b, r in rc[st].items():
            assert sorted(pc[st][b]) == sorted(r)
            for name, leaf in r.items():
                p, want = pc[st][b][name], np.asarray(leaf)
                assert str(p.dtype) == f"torch.{leaf.dtype}"
                if leaf.dtype == jnp.int8:
                    diff = np.abs(p.numpy().astype(int) - want)
                    assert diff.max() <= 1, f"{st}/{b}/{name}"
                    codes, flips = codes + diff.size, flips + diff.sum()
                elif name.endswith("_scale"):
                    np.testing.assert_allclose(p.numpy(), want, rtol=1e-5,
                                               atol=0)
                else:
                    np.testing.assert_array_equal(p.numpy(), want)
    # the codes are the same quantiser's on K/V that agree to f32 rounding:
    # a code flips only where x / scale lands within that rounding of a
    # half step
    assert codes > 0 and flips <= codes // 1000


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-236b"])
def test_int8_cache_close_to_forward(arch):
    """The reference's bar (tests/test_int8_kv.py): decode over the int8
    cache within 5% of the float forward, relative to its largest logit."""
    cfg = _cfg(arch)
    _, pparams = _both(cfg)
    toks = np.asarray(jax.random.randint(jax.random.key(4), (2, 8), 0,
                                         cfg.vocab_size))
    full, _, _ = P_lm.forward(cfg, pparams, torch.from_numpy(toks))
    dec, _ = _decode(cfg, pparams, torch.int8, toks, 16, port=True)
    full = full.numpy()
    assert np.abs(dec - full).max() / (np.abs(full).max() + 1e-9) < 0.05


def test_moe_int8_greedy_agreement():
    """The reference's MoE bar: greedy tokens over int8 and f32 caches
    agree at 75% of the positions at least."""
    cfg = get_reduced("olmoe-1b-7b")
    _, pparams = _both(cfg)
    toks = np.asarray(jax.random.randint(jax.random.key(4), (2, 8), 0,
                                         cfg.vocab_size))
    f32, _ = _decode(cfg, pparams, torch.float32, toks, 16, port=True)
    i8, _ = _decode(cfg, pparams, torch.int8, toks, 16, port=True)
    assert (f32.argmax(-1) == i8.argmax(-1)).mean() >= 0.75


def test_int8_batched_decode_keeps_an_idle_row():
    """decode_step_batched over an int8 cache: an inactive row's K/V,
    scales and positions keep their bits, and the active rows' tokens
    equal the reference's."""
    cfg = get_reduced("tinyllama-1.1b")
    rparams, pparams = _both(cfg)
    B, T = 3, 16
    rc = R_lm.init_cache(cfg, B, max_len=T, dtype=jnp.int8)
    pc = P_lm.init_cache(cfg, B, T, dtype=torch.int8, device="cpu")
    step = jax.jit(lambda p, c, t, pos, a: R_lm.decode_step_batched(
        cfg, p, c, t, pos, a))
    rng = np.random.default_rng(7)
    pos = np.zeros(B, np.int32)
    for i in range(6):
        toks = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
        active = np.array([True, i % 2 == 0, True])
        before = [t[:, 1].clone() for st in pc.values()
                  for c in st.values() for t in c.values()]
        rn, rc = step(rparams, rc, jnp.asarray(toks), jnp.asarray(pos),
                      jnp.asarray(active))
        pn, pc = P_lm.decode_step_batched(cfg, pparams, pc,
                                          torch.from_numpy(toks),
                                          torch.from_numpy(pos), active)
        np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
        after = [t[:, 1] for st in pc.values() for c in st.values()
                 for t in c.values()]
        if not active[1]:
            assert all(torch.equal(a, b) for a, b in zip(before, after))
        pos = pos + active


def test_prefill_into_int8_cache_raises_in_both():
    cfg = get_reduced("tinyllama-1.1b")
    rparams, pparams = _both(cfg)
    toks = np.arange(6, dtype=np.int32)[None]
    with pytest.raises(TypeError):
        R_lm.prefill(cfg, rparams, jnp.asarray(toks),
                     R_lm.init_cache(cfg, 1, max_len=16, dtype=jnp.int8))
    cache = P_lm.init_cache(cfg, 1, 16, dtype=torch.int8, device="cpu")
    with pytest.raises(TypeError, match="int8"):
        P_lm.prefill(cfg, pparams, torch.from_numpy(toks), cache)
    with pytest.raises(TypeError, match="int8"):
        P_lm.forward(cfg, pparams, torch.from_numpy(toks), cache=cache,
                     mode="prefill")
    assert all(not t.any() for st in cache.values() for c in st.values()
               for n, t in c.items() if n != "pos")


def test_decode_step_takes_one_token_a_row():
    cfg = get_reduced("tinyllama-1.1b")
    _, pparams = _both(cfg)
    cache = P_lm.init_cache(cfg, 1, 16, dtype=torch.int8, device="cpu")
    with pytest.raises(ValueError, match=r"\(B, 1\)"):
        P_lm.decode_step(cfg, pparams, cache,
                         torch.zeros((1, 2), dtype=torch.int32), 0)
