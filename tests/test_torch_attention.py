"""The port's attention (its plain chunked twin on the CPU) against the
reference's ``chunked_attention`` and Pallas ``flash_attention`` (interpret
mode), with ragged positions, 2**30 pads, a row with no valid key and
sliding windows over ring caches whose positions have wrapped.
Tolerances are the reference kernel tests' own: 3e-5 for f32, 2e-2 for
bf16 (tests/test_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro.kernels import ops as R_ops
from repro.models import attention as RA
from repro_torch.kernels import ops as P_ops
from repro_torch.kernels import ref as P_ref
from repro_torch.models import attention as PA

TOL = {"float32": 3e-5, "bfloat16": 2e-2}


def _pair(x, name):
    """The same values as a jax and a torch array of dtype ``name``."""
    t = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, name))
    return jnp.asarray(t.float().numpy()).astype(jnp.dtype(name)), t


def _err(p, r):
    return float(np.abs(p.float().numpy()
                        - np.asarray(r.astype(jnp.float32))).max())


CASES = [
    # B, S, H, K, T, D, block, dtype — decode (S=1), prefill, ragged T
    (3, 1, 8, 2, 40, 16, 16, "float32"),
    (2, 16, 4, 2, 16, 16, 32, "float32"),
    (2, 9, 4, 1, 37, 32, 8, "float32"),
    (3, 1, 8, 2, 40, 16, 16, "bfloat16"),
    (2, 16, 4, 2, 16, 16, 32, "bfloat16"),
]


@pytest.mark.parametrize("B,S,H,K,T,D,block,dt", CASES)
def test_chunked_attention_matches_reference(B, S, H, K, T, D, block, dt):
    rng = np.random.default_rng(7)
    rq, q = _pair(rng.standard_normal((B, S, H, D)), dt)
    rk, k = _pair(rng.standard_normal((B, T, K, D)), dt)
    rv, v = _pair(rng.standard_normal((B, T, K, D)), dt)
    # ragged cache: row b holds n_b valid tokens, the rest carry 2**30
    kv_pos = np.full((B, T), 2**30, np.int32)
    q_pos = np.zeros((B, S), np.int32)
    for b in range(B):
        n = int(rng.integers(S, T + 1))
        kv_pos[b, :n] = np.arange(n)
        q_pos[b] = np.arange(n - S, n)
    q_pos[0, 0] = -1                          # a row with no valid key -> 0
    out = PA.chunked_attention(q, k, v, torch.from_numpy(q_pos),
                               torch.from_numpy(kv_pos), block=block)
    ref = RA.chunked_attention(rq, rk, rv, jnp.asarray(q_pos),
                               jnp.asarray(kv_pos), block=block)
    assert out.dtype == q.dtype and out.shape == (B, S, H, D)
    assert _err(out, ref) < TOL[dt]
    assert not out[0, 0].float().any()


@pytest.mark.parametrize("B,H,K,S,T,D,causal,window,dt", [
    (1, 4, 2, 64, 64, 32, True, 0, "float32"),
    (2, 2, 1, 1, 100, 64, True, 0, "float32"),        # decode shape
    (1, 4, 4, 50, 50, 32, True, 12, "float32"),       # window (plain path)
    (1, 4, 2, 48, 48, 32, True, 16, "bfloat16"),      # window, bf16
    (1, 2, 2, 32, 32, 32, False, 0, "float32"),       # bidirectional
    (2, 8, 8, 32, 64, 32, True, 0, "bfloat16"),
])
def test_flash_attention_matches_pallas(B, H, K, S, T, D, causal, window, dt):
    rng = np.random.default_rng(8)
    rq, q = _pair(rng.standard_normal((B, H, S, D)), dt)
    rk, k = _pair(rng.standard_normal((B, K, T, D)), dt)
    rv, v = _pair(rng.standard_normal((B, K, T, D)), dt)
    out = P_ops.flash_attention(q, k, v, causal=causal, window=window)
    ref = R_ops.flash_attention(rq, rk, rv, causal=causal, window=window,
                                block_q=32, block_k=32)
    assert _err(out, ref) < TOL[dt]
    exact = P_ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert _err(exact, ref) < TOL[dt]


def _ring_positions(B, L, ends):
    """kv_pos of B ring caches of L slots: row b holds tokens
    max(0, n - L + 1) .. n in slot ``t % L`` (n = ends[b]), so once a row
    has wrapped its positions are not monotone in the slot index; slots
    that hold no token carry 2**30."""
    kv_pos = np.full((B, L), 2**30, np.int32)
    for b, n in enumerate(ends):
        t = np.arange(max(0, n - L + 1), n + 1)
        kv_pos[b, t % L] = t
    return kv_pos


WINDOW_CASES = [
    # B, S, H, K, L, D, window, block, dtype; S == 1 decodes over a ring of
    # L slots, S > 1 prefills S tokens of which the last ``pad`` are pads
    (4, 1, 8, 2, 16, 16, 16, 8, "float32"),
    (3, 1, 4, 2, 24, 32, 24, 32, "float32"),
    (3, 1, 4, 4, 40, 16, 12, 16, "float32"),      # ring longer than window
    (2, 30, 4, 2, 30, 16, 8, 16, "float32"),
    (4, 1, 8, 2, 16, 16, 16, 8, "bfloat16"),
    (2, 30, 4, 2, 30, 16, 8, 16, "bfloat16"),
]


@pytest.mark.parametrize("B,S,H,K,L,D,window,block,dt", WINDOW_CASES)
def test_chunked_attention_window_matches_reference(B, S, H, K, L, D,
                                                    window, block, dt):
    rng = np.random.default_rng(17)
    rq, q = _pair(rng.standard_normal((B, S, H, D)), dt)
    rk, k = _pair(rng.standard_normal((B, L, K, D)), dt)
    rv, v = _pair(rng.standard_normal((B, L, K, D)), dt)
    if S == 1:
        ends = rng.integers(L // 2, 4 * L, B)
        ends[0] = 3 * L + 5                   # wrapped: not monotone
        kv_pos = _ring_positions(B, L, ends)
        q_pos = ends[:, None].astype(np.int32)
        assert (np.diff(kv_pos[0]) < 0).any()
    else:
        q_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        q_pos[1, S - 7:] = 2**30              # padded q rows (and keys)
        kv_pos = q_pos.copy()
    out = PA.chunked_attention(q, k, v, torch.from_numpy(q_pos),
                               torch.from_numpy(kv_pos), window=window,
                               block=block)
    ref = RA.chunked_attention(rq, rk, rv, jnp.asarray(q_pos),
                               jnp.asarray(kv_pos), window=window,
                               block=block)
    assert out.dtype == q.dtype and out.shape == (B, S, H, D)
    assert _err(out, ref) < TOL[dt]
    if L > window:
        # the window masks keys here: without it the answer moves (a ring
        # of exactly ``window`` slots holds only keys inside the window)
        full = PA.chunked_attention(q, k, v, torch.from_numpy(q_pos),
                                    torch.from_numpy(kv_pos), block=block)
        assert _err(full, ref) > 10 * TOL[dt]


def test_cache_write_touches_active_rows_only():
    buf = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    before = buf.clone()
    val = torch.full((2, 1, 3), -1.0)
    PA._cache_write(buf, val, torch.tensor([4, 2]), torch.tensor([1]))
    assert torch.equal(buf[0], before[0])
    assert torch.equal(buf[1, 2], val[1, 0])
    buf[1, 2] = before[1, 2]
    assert torch.equal(buf, before)
