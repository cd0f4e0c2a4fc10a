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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
import _torch_families as FAM
from repro.configs import get_reduced
from repro.kernels import ops as R_ops
from repro.models import attention as RA
from repro.models import lm as R_lm
from repro_torch.kernels import ops as P_ops
from repro_torch.kernels import ref as P_ref
from repro_torch.models import lm as P_lm

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
    return (cfg, *FAM.both_params(cfg, 2))


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
    FAM.prefill_and_ragged_decode(*models)


def test_engine_stream_with_waves_matches_reference(models):
    """The same requests through both Engines: bucketed prefills, a suspend
    wave of two sessions, the rest drained (finishers suspend as a wave),
    then a resume wave: tokens step by step, stats, session positions and
    tokens, and the stored snapshots' page bytes equal, no resume failing
    its checksums."""
    FAM.engine_stream_with_waves(*models)


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
