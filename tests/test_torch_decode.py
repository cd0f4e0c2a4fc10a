"""The split-KV decode kernel's algorithm and layout, on the CPU.

The CUDA kernel (``csrc/flash_decode.cu``) cuts the cache slots
into splits, keeps f32 (max, sum, accumulator) for each split and combines
the splits in a fixed order.  Its plain twin ``ref.split_decode_ref`` runs
the same algorithm; here it is held against the port's plain chunked
attention and the reference's ``chunked_attention``
(``src/repro/models/attention.py``) on numpy inputs from a seed, with the
splits that ``decode_plan`` lays out for an H100 and with others: group
sizes 1-64, head dims 16-128, T not a multiple of the split length and
shorter than one split, splits and whole rows with no valid key (exactly 0),
a wrapped 1024-slot ring under window 1024, bf16.  Then the Engine decodes
reduced tinyllama and gemma3 with the twin in place of the decode attention
and must give the reference Engine's tokens.

Tolerances are the reference kernel tests' own: 3e-5 for f32, 2e-2 for
bf16 (tests/test_kernels.py); the twin differs from the chunked scan only
in summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs import get_reduced
from repro.models import attention as RA
from repro.models import lm as R_lm
from repro.serve.engine import Engine as REngine
from repro.serve.engine import Request as RRequest
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as P_ops
from repro_torch.kernels import ref as P_ref
from repro_torch.serve.engine import Engine as PEngine
from repro_torch.serve.engine import Request
from repro_torch.weights import params_from_jax

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
N_SM = 132                        # H100 SXM
SENTINEL = 2**30


def _pair(x, name):
    """The same values as a jax and a torch array of dtype ``name``."""
    t = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, name))
    return jnp.asarray(t.float().numpy()).astype(jnp.dtype(name)), t


def _inputs(seed, B, H, K, T, D, dt, ends, ring=False):
    """Decode inputs: row b holds tokens 0..ends[b]-1 (slot t % T for a
    ring, slot t otherwise) and queries position ends[b] - 1; an end of 0
    is a row with no valid key."""
    rng = np.random.default_rng(seed)
    rq, q = _pair(rng.standard_normal((B, 1, H, D)), dt)
    rk, k = _pair(rng.standard_normal((B, T, K, D)), dt)
    rv, v = _pair(rng.standard_normal((B, T, K, D)), dt)
    kv_pos = np.full((B, T), SENTINEL, np.int32)
    q_pos = np.zeros((B, 1), np.int32)
    for b, n in enumerate(ends):
        t = np.arange(max(0, n - T) if ring else 0, n)
        kv_pos[b, t % T if ring else t] = t
        q_pos[b, 0] = max(n - 1, 0)
    return (rq, rk, rv), (q, k, v), q_pos, kv_pos


def _check(jx, tx, q_pos, kv_pos, dt, n_split, split_len, **kw):
    """The twin against the port's chunked attention and the reference's;
    returns the twin's output."""
    qp, kp = torch.from_numpy(q_pos), torch.from_numpy(kv_pos)
    got = P_ref.split_decode_ref(*tx, qp, kp, n_split=n_split,
                                 split_len=split_len, **kw)
    plain = P_ref.chunked_attention_ref(*tx, qp, kp, **kw)
    want = RA.chunked_attention(*jx, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                                **kw)
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    assert float((got.float() - plain.float()).abs().max()) < TOL[dt]
    err = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert float(err.max()) < TOL[dt]
    return got


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 8, 64])
def test_split_decode_matches_reference(G, D):
    """decode_plan's splits of 16 slots over T = 100 (the last split holds
    4), row 0 ending at 37 so its later splits have no valid key."""
    K = 1 if G == 64 else 2
    B, T = 2, 100
    gc, n_groups, n_split, split_len = FA.decode_plan(B, K, G, T, 4, N_SM,
                                                      D)
    assert T % split_len and n_split * split_len >= T
    assert (n_split - 1) * split_len > 37            # splits past row 0's end
    jx, tx, q_pos, kv_pos = _inputs(G * 1000 + D, B, K * G, K, T, D,
                                    "float32", [37, T])
    _check(jx, tx, q_pos, kv_pos, "float32", n_split, split_len)


CASES = {  # name: (B, H, K, T, D, dtype, ends, ring, window, causal, splits)
    "shorter-than-one-split": (2, 4, 2, 10, 32, "float32", [4, 10], False,
                               0, True, (1, 16)),
    "many-splits-ragged-T": (3, 8, 2, 203, 64, "float32", [1, 150, 203],
                             False, 0, True, (13, 16)),
    "empty-row": (3, 8, 2, 64, 32, "float32", [0, 17, 64], False, 0, True,
                  (4, 16)),
    "window-empties-early-splits": (2, 4, 1, 128, 16, "float32", [128, 90],
                                    False, 20, True, (8, 16)),
    "ring-1024-wrapped": (3, 4, 2, 1024, 128, "float32", [1500, 2047, 700],
                          True, 1024, True, (8, 128)),
    "ring-1024-wrapped-bf16": (3, 4, 2, 1024, 128, "bfloat16",
                               [1500, 2047, 700], True, 1024, True,
                               (8, 128)),
    # D = 32: q * 32**-0.5 rounds in bf16 (64's 1/8 would be exact)
    "bf16-q-scaling-G8": (2, 16, 2, 77, 32, "bfloat16", [77, 30], False, 0,
                          True, (5, 16)),
    "bidirectional": (2, 4, 2, 50, 32, "float32", [50, 50], False, 0, False,
                      (4, 16)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_decode_edge_cases(name):
    B, H, K, T, D, dt, ends, ring, window, causal, (ns, sl) = CASES[name]
    jx, tx, q_pos, kv_pos = _inputs(len(name), B, H, K, T, D, dt, ends,
                                    ring=ring)
    if ring:
        wrapped = [b for b, n in enumerate(ends) if n > T and n % T]
        assert wrapped and all((np.diff(kv_pos[b]) < 0).any()
                               for b in wrapped)
    got = _check(jx, tx, q_pos, kv_pos, dt, ns, sl, causal=causal,
                 window=window)
    for b, n in enumerate(ends):
        if n == 0:                   # no valid key: exactly 0, not NaN
            assert not got[b].float().any()


@pytest.mark.parametrize("B,K,G,T,itemsize", [
    (4, 16, 2, 1024, 4), (4, 16, 2, 2048, 4), (8, 4, 8, 1024, 4),
    (8, 4, 8, 256, 4), (2, 1, 64, 77, 4), (3, 2, 3, 1000, 4),
    (1, 1, 1, 1, 4), (1, 1, 1, 5, 2), (8, 4, 8, 1024, 2), (64, 8, 4, 33, 4),
    (1, 8, 16, 32768, 2), (1, 1, 1, 1 << 20, 4),
])
def test_decode_plan_covers_the_cache_without_empty_splits(B, K, G, T,
                                                           itemsize):
    plan = FA.decode_plan(B, K, G, T, itemsize, N_SM, 128)
    assert plan == FA.decode_plan(B, K, G, T, itemsize, N_SM, 128)  # same
    gc, n_groups, n_split, split_len = plan
    assert gc in (2, 4, 8) and gc * (16 // itemsize) <= 32
    assert n_groups == -(-G // gc) and (n_groups - 1) * gc < G
    assert 1 <= n_split <= FA.MAX_SPLITS
    assert split_len % FA.SPLIT_ALIGN == 0
    assert (n_split - 1) * split_len < T <= n_split * split_len


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 8, 64])
def test_decode_plan_at_head_dim_256(G, itemsize):
    """At head dim 256 a lane holds 8 floats of a head's q and accumulator
    (two 16-byte chunks of an f32 row, one of a bf16 row), so a CTA holds
    at most 4 heads, in f32 as in bf16; below 256 an f32 cache keeps 8."""
    gc, n_groups, n_split, split_len = FA.decode_plan(4, 16, G, 1024,
                                                      itemsize, N_SM, 256)
    assert gc in (2, 4) and gc * 8 <= 32
    assert gc == min(4, max(2, 1 << max(0, G - 1).bit_length()))
    assert n_groups == -(-G // gc)
    assert (n_split - 1) * split_len < 1024 <= n_split * split_len
    assert FA.decode_plan(4, 16, 8, 1024, 4, N_SM, 128)[0] == 8
    assert FA.decode_plan(4, 16, 8, 1024, 2, N_SM, 128)[0] == 4


@pytest.mark.parametrize("name,B,K,G,T,D", [
    ("gemma3-ring", 4, 16, 2, 1024, 128),
    ("gemma3-global", 4, 16, 2, 2048, 128),
    ("tinyllama-1024", 8, 4, 8, 1024, 64),
    ("tinyllama-256", 8, 4, 8, 256, 64),
])
def test_decode_plan_fills_the_card_at_the_path_shapes(name, B, K, G, T, D):
    gc, n_groups, n_split, _ = FA.decode_plan(B, K, G, T, 4, N_SM, D)
    assert n_split * n_groups * K * B >= 2 * N_SM


def _twin_decode(q, k, v, q_pos, kv_pos, *, causal=True, window=0,
                 block=512):
    """ops.chunked_attention with decode through the split-KV twin, laid
    out as the card would lay it out."""
    if q.shape[1] != 1:
        return P_ref.chunked_attention_ref(q, k, v, q_pos, kv_pos,
                                           causal=causal, window=window,
                                           block=block)
    B, _, H, D = q.shape
    K = k.shape[2]
    _twin_decode.calls += 1
    _, _, n_split, split_len = FA.decode_plan(B, K, H // K, k.shape[1],
                                              k.element_size(), N_SM, D)
    return P_ref.split_decode_ref(q, k, v, q_pos, kv_pos, n_split=n_split,
                                  split_len=split_len, causal=causal,
                                  window=window)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-27b"])
def test_engine_decodes_through_the_twin_like_the_reference(arch,
                                                            monkeypatch):
    """The slice as a whole: the Engine's decode steps with the split-KV
    algorithm (ring caches past the window for gemma3) give the reference
    Engine's tokens."""
    cfg = get_reduced(arch)
    rparams = R_lm.init_lm(cfg, jax.random.key(5))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams),
                              device="cpu")
    monkeypatch.setattr(P_ops, "chunked_attention", _twin_decode)
    _twin_decode.calls = 0
    kw = dict(slots=3, max_len=64, n_sessions=8)
    r, p = REngine(cfg, rparams, **kw), PEngine(cfg, pparams, device="cpu",
                                                **kw)
    rng = np.random.default_rng(9)
    reqs = []
    for uid, (n, max_new) in enumerate([(5, 30), (19, 24), (11, 36)]):
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        rq, pq = RRequest(uid, prompt, max_new), Request(uid, prompt, max_new)
        r.submit(rq), p.submit(pq)
        reqs.append((rq, pq))
    while r.active:
        r.step(), p.step()
    assert not p.active and _twin_decode.calls > 0
    for rq, pq in reqs:
        assert pq.generated == rq.generated and len(pq.generated) > 20
