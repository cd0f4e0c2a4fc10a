"""The MLA family against the reference: ``mla_block`` on both of its
paths, the attention twin at MLA's head dims, and reduced deepseek-v2-236b
(MLA + MoE) as a model.

- ``mla_block`` expanded (prefill: K3 at Dk = qk_nope + qk_rope, Dv =
  v_dim) and absorbed (decode over the compressed cache, ragged rows, one
  row idle), within 1e-5, the caches' written entries equal.
- The plain chunked twin and the card's rounding twin (``prefill_tc_ref``,
  3xTF32) at Dk 192 / Dv 128 against the reference's ``chunked_attention``
  within 3e-5; ``attention_bar`` at Dv != Dk.  The Pallas kernel takes one
  head dim, so there is no interpret-mode comparison here.
- Reduced deepseek-v2 from the reference's weights: prefill, 48 ragged
  decode steps and an Engine stream with waves (tests/_torch_families.py).
- Reduced deepseek-v2 with the reference's bf16 weights over the Engine's
  f32 cache, teacher-forced, with tests/test_torch_bf16.py's bars and its
  way round the reference's prefill ``TypeError``; positions whose expert
  choice moved are exempt only where the reference's router has a
  near-tie.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
import _torch_families as FAM
from repro.configs import get_reduced
from repro.models import attention as RA
from repro.models import lm as R_lm
from repro_torch.kernels import ops as P_ops
from repro_torch.kernels import ref as P_ref
from repro_torch.models import attention as PA
from repro_torch.models import lm as P_lm
from repro_torch.weights import params_from_jax
from test_torch_bf16 import (KV_ULPS, LOGIT_ULPS, MAX_LEN, SLOTS,
                             _f32, _r_decode_logits, _r_prefill_row, _ulp)

ARCH = "deepseek-v2-236b"


def _mla_kw(cfg):
    return dict(n_heads=cfg.n_heads, q_lora=cfg.q_lora_rank,
                kv_lora=cfg.kv_lora_rank, qk_nope=cfg.qk_nope_dim,
                qk_rope=cfg.qk_rope_dim, v_dim=cfg.v_head_dim,
                rope_theta=cfg.rope_theta, block=cfg.attn_block)


@pytest.fixture(scope="module")
def block():
    cfg = get_reduced(ARCH)
    rp = RA.init_mla_params(jax.random.key(3), cfg.d_model, cfg.n_heads,
                            cfg.q_lora_rank, cfg.kv_lora_rank,
                            cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim)
    pp = params_from_jax(jax.tree.map(np.asarray, rp), device="cpu")
    return cfg, rp, pp


def test_mla_block_expanded_matches_reference(block):
    """No cache: the expanded K (qk_nope + qk_rope wide) and V (v_dim)
    through chunked_attention, causal, over 2 x 45 tokens (past the
    reduced attn_block of 32); the compressed entries a prefill writes."""
    cfg, rp, pp = block
    x = np.random.default_rng(4).standard_normal(
        (2, 45, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(45, dtype=np.int32), (2, 45))
    ry, _ = RA.mla_block(rp, jnp.asarray(x), jnp.asarray(pos),
                         **_mla_kw(cfg))
    py, (c_kv, k_rope) = PA.mla_block(pp, torch.from_numpy(x),
                                      torch.from_numpy(pos.copy()),
                                      **_mla_kw(cfg))
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), rtol=0, atol=1e-5)
    _, _, rc, rr = RA._mla_qkr(rp, jnp.asarray(x), jnp.asarray(pos),
                               cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                               cfg.kv_lora_rank, cfg.rope_theta)
    np.testing.assert_allclose(c_kv.numpy(), np.asarray(rc), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(k_rope.numpy(), np.asarray(rr), rtol=0,
                               atol=1e-5)


def test_mla_block_absorbed_decode_matches_reference(block):
    """One decode token per row over a compressed cache at ragged
    positions: the reference writes every row, the port the active ones
    (row 2 idle keeps its cache bits); y of the active rows within 1e-5,
    the written entries equal."""
    cfg, rp, pp = block
    B, T = 4, 40
    rng = np.random.default_rng(5)
    cc = rng.standard_normal((B, T, cfg.kv_lora_rank)).astype(np.float32)
    cr = rng.standard_normal((B, T, cfg.qk_rope_dim)).astype(np.float32)
    lens = np.array([3, 17, 9, 39], np.int32)
    cpos = np.full((B, T), 2**30, np.int32)
    for b, n in enumerate(lens):
        cpos[b, :n] = np.arange(n)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ry, (rcc, rcr, rpos, _) = RA.mla_block(
        rp, jnp.asarray(x), jnp.asarray(lens[:, None]), **_mla_kw(cfg),
        kv_cache=(jnp.asarray(cc), jnp.asarray(cr), jnp.asarray(cpos)),
        cache_index=jnp.asarray(lens))
    pcache = tuple(torch.from_numpy(a.copy()) for a in (cc, cr, cpos))
    rows = torch.tensor([0, 1, 3])
    py, _ = PA.mla_block(pp, torch.from_numpy(x),
                         torch.from_numpy(lens[:, None].copy()),
                         **_mla_kw(cfg), kv_cache=pcache,
                         cache_index=torch.from_numpy(lens), rows=rows)
    np.testing.assert_allclose(py.numpy()[rows], np.asarray(ry)[rows],
                               rtol=0, atol=1e-5)
    for got, want, before in zip(pcache, (rcc, rcr, rpos), (cc, cr, cpos)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy()[rows], want[rows], rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(got.numpy()[2], before[2])


def _mla_case(B, S, H, seed, dk=192, dv=128):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dk)).astype(np.float32)
    k = rng.standard_normal((B, S, H, dk)).astype(np.float32)
    v = rng.standard_normal((B, S, H, dv)).astype(np.float32)
    pos = np.full((B, S), 2**30, np.int32)
    for b in range(B):                     # ragged prompts, pads at 2**30
        n = S if b == B - 1 else int(rng.integers(1, S + 1))
        pos[b, :n] = np.arange(n)
    return q, k, v, pos


@pytest.mark.parametrize("B,S,H", [(2, 40, 4), (1, 70, 2)])
def test_mla_head_dims_twins_match_reference(B, S, H):
    """Dk 192 / Dv 128, causal, padded rows: the plain chunked twin (what
    the card's kernel is held to) and the 3xTF32 emulation of the prefill
    kernel (at the prompts' rows) against the reference's
    chunked_attention within 3e-5."""
    q, k, v, pos = _mla_case(B, S, H, seed=B * S + H)
    want = np.asarray(RA.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), block=32))
    args = tuple(torch.from_numpy(a) for a in (q, k, v, pos, pos))
    got = P_ops.chunked_attention(*args, block=32)
    assert tuple(got.shape) == (B, S, H, 128)
    assert float(np.abs(got.numpy() - want).max()) < 3e-5
    # at the valid query rows: a pad row (2**30) also sees the zero keys
    # the reference pads its last block with, which the kernel has not
    tc = P_ref.prefill_tc_ref(*args)
    assert tuple(tc.shape) == (B, S, H, 128)
    real = pos < 2**30
    assert float(np.abs(tc.numpy() - want)[real].max()) < 3e-5


def test_attention_bar_at_mla_head_dims():
    """``attention_bar`` takes Dv != Dk as it is: its shape is the
    output's, 3e-5 for an f32 output; for bf16, above 3e-5 and at most
    the cap, and a bf16 result rounded from the f32 one meets it."""
    q, k, v, pos = _mla_case(1, 33, 2, seed=11)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    qp = kp = torch.from_numpy(pos)
    want = P_ref.chunked_attention_ref(*args, qp, kp)
    bar = P_ref.attention_bar(want, want, *args, qp, kp)
    assert bar.shape == want.shape and bool((bar == P_ref.F32_BAR).all())
    bf = [t.bfloat16() for t in args]
    want_b = P_ref.chunked_attention_ref(*bf, qp, kp)
    got_b = P_ref.chunked_attention_ref(*[t.float() for t in bf], qp,
                                        kp).bfloat16()
    bar_b = P_ref.attention_bar(got_b, want_b, *bf, qp, kp)
    assert bar_b.shape == want_b.shape
    assert bool((bar_b > P_ref.F32_BAR).all())
    assert bool((bar_b <= P_ref.BF16_CAP).all())
    assert bool(((got_b.float() - want_b.float()).abs() <= bar_b).all())


@pytest.fixture(scope="module")
def deepseek():
    cfg = get_reduced(ARCH)
    return (cfg,) + FAM.both_params(cfg, 2)


def test_deepseek_params_and_cache_layout_match(deepseek):
    cfg, rparams, pparams = deepseek
    own = P_lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(rparams)[0]:
        for tree in (pparams, own):
            node = tree
            for k in path:
                node = node[k.key]
            assert tuple(node.shape) == leaf.shape
            assert str(node.dtype) == f"torch.{leaf.dtype}"
    rc = R_lm.init_cache(cfg, 3, max_len=20)
    pc = P_lm.init_cache(cfg, 3, 20, device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(rc)[0]:
        node = pc
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_deepseek_prefill_and_ragged_decode_match(deepseek):
    FAM.prefill_and_ragged_decode(*deepseek)


def test_deepseek_engine_stream_with_waves_matches_reference(deepseek):
    FAM.engine_stream_with_waves(*deepseek)


# a router near-tie: the k-th and (k+1)-th expert probabilities closer than
# this, where the bf16 rounding of the MoE input can swap the two
ROUTE_TIE = 2.0**-6


def _route_recorder(moe, top_k, log, jitted):
    """``moe.moe_block`` that first logs each token's sorted top-k expert
    ids and the gap between its k-th and (k+1)-th router probabilities
    (through ``jax.debug.callback`` when ``jitted``)."""
    inner = moe.moe_block

    def block(params, x, **kw):
        if jitted:
            probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(
                jnp.float32) @ params["router"], axis=-1)
            top, ids = jax.lax.top_k(probs, top_k + 1)
            jax.debug.callback(
                lambda g, i: log.append((np.asarray(g), np.asarray(i))),
                top[:, -2] - top[:, -1], jnp.sort(ids[:, :-1], axis=-1),
                ordered=True)
        else:
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                  @ params["router"], dim=-1)
            top, ids = torch.topk(probs, top_k + 1, dim=-1)
            log.append(((top[:, -2] - top[:, -1]).numpy(),
                        ids[:, :-1].sort(dim=-1).values.numpy()))
        return inner(params, x, **kw)
    return block


def _routes(log, keep=slice(None)):
    """One forward's log -> (gaps, ids), each (tokens, layers, ...)."""
    if log and not isinstance(log[0][0], np.ndarray):
        jax.effects_barrier()
    gaps = np.stack([g for g, _ in log], 1)[keep]
    ids = np.stack([i for _, i in log], 1)[keep]
    log.clear()
    return gaps, ids


def test_deepseek_bf16_weights_over_f32_cache_match_reference(monkeypatch):
    """Prefill of four prompts, then 24 teacher-forced ragged decode steps
    (row 2 idle for eight), against the jitted reference.

    bf16 moves an MoE model's routing: a token whose k-th and (k+1)-th
    expert probabilities are close takes another expert under another
    rounding of its input, and its logits move by far more than bf16's
    rounding from then on.  So the test logs both models' routing, layer
    by layer, and holds:
    - every position whose experts differ from the reference's at some
      layer first differs where the reference's own k-th and (k+1)-th
      probabilities are within ROUTE_TIE, and at most 1 position in 10
      differs; such a position is exempt from the bars below;
    - every other position's logits within 2 LOGIT_ULPS ulps (a position
      that attends to a swapped one's cache entries moves a little), the
      median within LOGIT_ULPS and at most 1 in 10 beyond, and its greedy
      token equal unless the reference's top two are within 2 ulps;
    - the first layer's cc/cr, which no routing precedes, within KV_ULPS
      ulps of each leaf's largest."""
    from repro.models import moe as R_moe
    from repro_torch.models import moe as P_moe
    cfg = get_reduced(ARCH)
    rlog, plog_ = [], []
    monkeypatch.setattr(R_moe, "moe_block",
                        _route_recorder(R_moe, cfg.top_k, rlog, True))
    monkeypatch.setattr(P_moe, "moe_block",
                        _route_recorder(P_moe, cfg.top_k, plog_, False))
    rparams = R_lm.init_lm(cfg, jax.random.key(0), dtype=jnp.bfloat16)
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    r_prefill = jax.jit(partial(_r_prefill_row, cfg), static_argnums=3)
    r_decode = jax.jit(partial(_r_decode_logits, cfg))
    rng = np.random.default_rng(3)
    rcache = R_lm.init_cache(cfg, SLOTS, max_len=MAX_LEN)
    pcache = P_lm.init_cache(cfg, SLOTS, MAX_LEN, device="cpu")
    outs = []                  # (reference, port) logits, routes
    prompts = (5, 12, 20, 33)
    for s, n in enumerate(prompts):
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        rl, rcache = r_prefill(rparams, prompt, rcache, s)
        plog, _ = P_lm.prefill(cfg, pparams, torch.from_numpy(prompt)[None],
                               pcache, slot=s)
        assert plog.dtype == torch.bfloat16
        outs.append((_f32(rl), plog[0].float().numpy(), _routes(rlog),
                     _routes(plog_)))
    pos = np.array(prompts, np.int32)
    for step in range(24):
        toks = rng.integers(0, cfg.vocab_size, SLOTS).astype(np.int32)
        active = np.ones(SLOTS, bool)
        if 6 <= step < 14:
            active[2] = False
        rl, rcache = r_decode(rparams, rcache, jnp.asarray(toks),
                              jnp.asarray(pos), jnp.asarray(active))
        pl = P_lm.decode_logits(cfg, pparams, pcache, torch.from_numpy(toks),
                                torch.from_numpy(pos), active)
        outs.append((_f32(rl)[active], pl[:, -1].float().numpy()[active],
                     _routes(rlog, active), _routes(plog_, active)))
        pos = pos + active
    r = np.concatenate([o[0] for o in outs])
    p = np.concatenate([o[1] for o in outs])
    rgap = np.concatenate([o[2][0] for o in outs])      # (positions, layers)
    rids = np.concatenate([o[2][1] for o in outs])
    pids = np.concatenate([o[3][1] for o in outs])
    assert rids.shape == pids.shape == rgap.shape + (cfg.top_k,)
    differs = (rids != pids).any(-1)                    # (positions, layers)
    swapped = differs.any(-1)
    first = differs.argmax(-1)[swapped]
    print(f"routing differs at {int(swapped.sum())} of {len(r)} positions; "
          f"the reference's gaps there: {rgap[swapped, first]}")
    assert (rgap[swapped, first] < ROUTE_TIE).all()
    assert swapped.sum() <= len(r) // 10
    bar = LOGIT_ULPS * _ulp(float(np.abs(r).max()))
    dev = np.abs(p - r).max(-1)[~swapped]
    assert dev.max() <= 2 * bar and np.median(dev) <= bar
    assert (dev > bar).sum() <= len(dev) // 10
    tr, tp = r.argmax(-1)[~swapped], p.argmax(-1)[~swapped]
    top = r[~swapped].max(-1)
    tie = r[~swapped][np.arange(tp.size), tp] >= top - 2 * _ulp(top)
    np.testing.assert_array_equal(tp[~tie], tr[~tie])
    st, b = sorted(pcache)[0], "b0"
    rpos = np.asarray(rcache[st][b]["pos"])[0]
    np.testing.assert_array_equal(pcache[st][b]["pos"].numpy()[0], rpos)
    valid = rpos < 2**30
    for name in ("cc", "cr"):
        pk = pcache[st][b][name][0]
        assert pk.dtype == torch.float32
        rk = _f32(rcache[st][b][name][0])[valid]
        assert float(np.abs(pk.numpy()[valid] - rk).max()) <= \
            KV_ULPS * _ulp(float(np.abs(rk).max()))


@pytest.mark.parametrize("f32,stages", [(True, 1), (False, 2)])
def test_prefill_plan_at_mla_head_dims(f32, stages):
    """Dk 192 / Dv 128: rows by Dv (128, one warp a 16-row block, as at
    128), stages by Dk (one in f32, whose 128-row Q and one tile fill the
    CTA's shared memory; two in bf16, the wgmma route's 128-key tiles);
    head dim 256 keeps its 64 rows in f32 (128 on the bf16 route)."""
    from repro_torch.kernels import flash_attention as FA
    plan = FA.prefill_plan(1, 1024, 128, 128, 192, f32, 128)
    assert (plan.rows, plan.stages, plan.bq) == (128, stages, 128)
    assert plan.grid == (8, 128, 1)
    assert plan.route == ("mma" if f32 else "wgmma")
    assert plan.keys == (64 if f32 else 128)
    assert FA.prefill_plan(1, 1024, 16, 16, 256, f32, 256).rows == (
        64 if f32 else 128)
    assert FA.prefill_plan(1, 1024, 16, 16, 128, f32, 128).rows == 128


def test_short_form_at_mla_head_dims():
    """deepseek-v2's f32 bucket 64 (128 heads over 128 kv heads, Dk 192 /
    Dv 128) on 132 SMs: the full form's 128-row CTAs would hold 64 rows
    each, so the plan takes the short form: 32 rows (two row blocks, each
    scored by two warps over half of each tile's keys), one stage, two
    query blocks a head: 256 CTAs, one wave at the two CTAs an SM an H100
    holds at 32 rows (its occupancy at 64, 32 and 16 rows: 1, 2, 2); the
    bucket 1024 and K3e's forward (``lse``) keep the full form."""
    from repro_torch.kernels import flash_attention as FA
    plan = FA.prefill_plan(1, 64, 128, 128, 192, True, 128, T=64, n_sm=132,
                           per_sm=(1, 2, 2))
    assert plan.form == "short" and plan.halves == 1
    assert (plan.rows, plan.heads, plan.bq) == (32, 1, 32)
    assert (plan.keys, plan.stages, plan.width) == (64, 1, 192)
    assert plan.grid == (2, 128, 1)
    full = FA.prefill_plan(1, 1024, 128, 128, 192, True, 128)
    assert FA.prefill_plan(1, 1024, 128, 128, 192, True, 128, T=1024,
                           n_sm=132) == full
    assert FA.prefill_plan(1, 64, 128, 128, 192, True, 128, T=64, n_sm=132,
                           lse=True) == FA.prefill_plan(1, 64, 128, 128,
                                                        192, True, 128)


@pytest.mark.parametrize("B,S,H,window", [(2, 64, 4, 0), (2, 64, 4, 24),
                                          (1, 100, 2, 0)])
def test_short_form_emulation_at_mla_head_dims(B, S, H, window):
    """``ref.prefill_short_ref`` at Dk 192 / Dv 128 (each CTA's rows, each
    warp's keys of a tile apart, then combined) against the reference's
    ``chunked_attention`` within 3e-5: ragged prompts padded at 2**30, a
    window, T past one tile, and a query (batch row 0's first) at position
    -1, which sees no key (exactly 0)."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v, pos = _mla_case(B, S, H, seed=S + H + window)
    qp = pos.copy()
    qp[0, 0] = -1
    want = np.asarray(RA.chunked_attention(
        *(jnp.asarray(a) for a in (q, k, v, qp, pos)), window=window))
    plan = FA.prefill_plan(B, S, H, H, 192, True, 128, T=S, n_sm=132)
    assert plan.form == "short"
    got = P_ref.prefill_short_ref(
        *(torch.from_numpy(a) for a in (q, k, v, qp, pos)), plan,
        window=window)
    assert tuple(got.shape) == (B, S, H, 128)
    assert float(np.abs(got.numpy() - want).max()) < 3e-5
    assert not got[0, 0].any()
