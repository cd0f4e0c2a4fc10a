"""The port's LM from the reference's own weights (params_from_jax): prefill
logits and 48 teacher-forced ragged decode steps against the reference.

Bound: f32 throughout, reduced tinyllama (4 layers, d_model 64), so the two
frameworks differ only in summation order — a few f32 ulps per op, far
below atol 1e-4 on O(1) logits and cache entries.  Greedy tokens must be
equal.  Cache slots holding no token carry position 2**30, whose RoPE angle
(~1e9 rad) the two frameworks round differently; those slots are never
attended, so caches are compared at valid positions only."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs import get_reduced
from repro.models import lm as R_lm
from repro_torch.models import lm as P_lm
from repro_torch.weights import params_from_jax

SLOTS, MAX_LEN, PROMPTS, STEPS, ATOL = 4, 96, (6, 9, 12, 15), 48, 1e-4


@pytest.fixture(scope="module")
def models():
    cfg = get_reduced("tinyllama-1.1b")
    rparams = R_lm.init_lm(cfg, jax.random.key(0))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    return cfg, rparams, pparams


def _padded(prompt, lb=16):
    toks = np.zeros(lb, np.int32)
    toks[:len(prompt)] = prompt
    pos = np.full(lb, 2**30, np.int32)
    pos[:len(prompt)] = np.arange(len(prompt))
    return toks, pos


def _same_cache(pc, rc, atol):
    for name in ("pos", "k", "v"):
        p = pc["stage0"]["b0"][name].numpy()
        r = np.asarray(rc["stage0"]["b0"][name])
        if name == "pos":
            np.testing.assert_array_equal(p, r)
            valid = r < 2**30
        else:
            np.testing.assert_allclose(p[valid], r[valid], rtol=0, atol=atol)


def test_params_layout_matches(models):
    cfg, rparams, pparams = models
    flat_r = jax.tree_util.tree_flatten_with_path(rparams)[0]
    assert len(flat_r) > 0
    for path, leaf in flat_r:
        node = pparams
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape


def test_prefill_and_ragged_decode_match(models):
    cfg, rparams, pparams = models
    assert P_lm.stages_of(cfg) == R_lm.stages_of(cfg)
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
        P_lm.reset_slot(pcache, s)
        plog, _ = P_lm.prefill(cfg, pparams, torch.from_numpy(toks)[None],
                               pcache, positions=torch.from_numpy(pos)[None],
                               slot=s)
        n = len(prompt)
        np.testing.assert_allclose(plog[0, :n].numpy(),
                                   np.asarray(rlog[0, :n]), rtol=0, atol=ATOL)
        assert int(plog[0, n - 1].argmax()) == int(rlog[0, n - 1].argmax())
    _same_cache(pcache, rcache, ATOL)

    r_decode = jax.jit(partial(R_lm.decode_step_batched, cfg))
    pos = np.array(PROMPTS, np.int32)
    for step in range(STEPS):
        toks = rng.integers(0, cfg.vocab_size, SLOTS).astype(np.int32)
        active = np.ones(SLOTS, bool)
        if 10 <= step < 20:
            active[3] = False                 # slot 3 idles for 10 steps
        frozen = pcache["stage0"]["b0"]["k"][:, 3].clone()
        rn, rcache = r_decode(rparams, rcache, jnp.asarray(toks),
                              jnp.asarray(pos), jnp.asarray(active))
        pn, pcache = P_lm.decode_step_batched(
            cfg, pparams, pcache, torch.from_numpy(toks),
            torch.from_numpy(pos), active)
        np.testing.assert_array_equal(pn.numpy(), np.asarray(rn))
        if not active[3]:
            assert int(pn[3]) == -1
            assert torch.equal(pcache["stage0"]["b0"]["k"][:, 3], frozen)
        pos = pos + active
    _same_cache(pcache, rcache, ATOL)


def test_other_layer_kinds_raise():
    """Every layer kind is ported; what still raises is an enc-dec prefill
    whose frame count is not the cache's enc_len (the port writes its
    caches in place, where the reference would replace the leaves)."""
    from repro_torch.configs import get_reduced as p_reduced
    cfg = p_reduced("seamless-m4t-medium")
    params = P_lm.init_lm(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    cache = P_lm.init_cache(cfg, 1, 8, device="cpu")        # enc_len 0
    with pytest.raises(ValueError, match="enc_len"):
        P_lm.prefill(cfg, params, torch.zeros((1, 4), dtype=torch.long),
                     cache, enc_embeds=torch.zeros((1, 5, cfg.d_model)))
