"""The tensor-core prefill kernel's layout and arithmetic, on the CPU.

The CUDA kernel (``csrc/flash_attention.cu``, namespace ``pf``) computes
attention for S > 1 on the H100's tensor cores.  Two things about it can be
held here, without the card:

- its layout: ``prefill_plan`` and ``prefill_row`` (the kernel's own index
  math) give every (query, head) row of q to exactly one CTA row, and the
  64-key tiles every key to exactly one tile, at the serving paths' shapes
  (tinyllama's buckets, the launcher's forked prefix, gemma3's prompts)
  and at ragged ones;
- its arithmetic: ``ref.prefill_tc_ref`` repeats it in plain PyTorch (TF32
  rounding of the operands, the three-product 3xTF32 split, f32 sums and
  the online softmax per 64-key tile).  On numpy inputs from a seed it holds
  the reference's ``chunked_attention`` (``src/repro/models/attention.py``)
  to the reference kernel tests' 3e-5, at head_dim 64, 128 and 256, under a
  window of 100 over S = 300 and over rows that see 1024-1500 keys, while a
  single TF32 pass does not: that is why the kernel splits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as P_ref

TOL = 3e-5                        # tests/test_kernels.py, f32
SENTINEL = 2**30

# (S, H, K): the shapes the smoke run's serving phases prefill
PATH_SHAPES = ([(s, 32, 4) for s in (16, 32, 64, 128, 256, 512)]  # tinyllama
               + [(s, 32, 16) for s in (96, 300, 700, 1010, 1100, 1500)])


def _coverage(B, S, H, K, head_dim=128, f32=True):
    """How many CTA rows compute each (batch, query, head): the grid of
    ``prefill_plan`` walked through ``prefill_row``."""
    plan = FA.prefill_plan(B, S, H, K, head_dim, f32)
    G = H // K
    nq, nk, nb = plan.grid
    assert (nk, nb) == (K, B) and plan.bq * G <= plan.rows
    seen = np.zeros((B, S, H), np.int64)
    for qb in range(nq):
        for kvh in range(K):
            for r in range(plan.rows):
                got = FA.prefill_row(plan, S, G, qb, kvh, r)
                if got is not None:
                    s, h = got
                    assert h // G == kvh            # GQA: its own kv head
                    seen[:, s, h] += 1
    return plan, seen


@pytest.mark.parametrize("S,H,K", PATH_SHAPES)
def test_prefill_plan_covers_path_shapes(S, H, K):
    plan, seen = _coverage(1, S, H, K)
    assert (seen == 1).all()
    assert (plan.rows, plan.keys, plan.stages) == (128, 64, 2)


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 8, 64])
@pytest.mark.parametrize("S", [1, 37, 300, 1500])
def test_prefill_plan_covers_ragged_shapes(S, G, D):
    """Every row once for S not a multiple of a CTA's queries, every key
    once in the tiles for T = S + D (not a multiple of 64), and the head
    dim read once by the f32 fragment order the kernel documents."""
    K = 2
    plan, seen = _coverage(2, S, K * G, K)
    assert (seen == 1).all()
    T = S + D
    keys = np.zeros(T, np.int64)
    for t0 in range(0, T, plan.keys):
        keys[t0:min(T, t0 + plan.keys)] += 1
    assert (keys == 1).all()
    # f32: k-block blk of KPB k-steps; lane t's k-step kk reads dims
    # blk*8*KPB + 2*KPB*t + 2*kk + {0, 1}
    kpb = 4 if D >= 32 else D // 8
    dims = sorted(blk * 8 * kpb + 2 * kpb * t + 2 * kk + e
                  for blk in range(D // (8 * kpb)) for t in range(4)
                  for kk in range(kpb) for e in range(2))
    assert dims == list(range(D))


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("G", [1, 2, 8, 64])
@pytest.mark.parametrize("S", [1, 37, 300, 1024])
def test_prefill_plan_at_head_dim_256(S, G, f32):
    """Head dim 256 (gemma-7b): two warps share each 16-row block, so a CTA
    holds 64 rows; the f32 path (q or K/V f32) has one K/V stage, bf16 two.
    Every (query, head) row once, G = 64 at one query a CTA, and the head
    dim read once by the f32 fragment order (eight k-blocks)."""
    K = 2
    plan, seen = _coverage(2, S, K * G, K, 256, f32)
    assert (seen == 1).all()
    assert (plan.rows, plan.keys, plan.stages) == (64, 64, 1 if f32 else 2)
    assert plan.bq == 64 // G
    dims = sorted(blk * 32 + 8 * t + 2 * kk + e for blk in range(8)
                  for t in range(4) for kk in range(4) for e in range(2))
    assert dims == list(range(256))


@pytest.mark.parametrize("S", [16, 64, 256, 512, 1024])
def test_prefill_plan_covers_gemma_7b_buckets(S):
    """gemma-7b's Engine buckets (16 heads over 16 kv heads, head dim
    256): one query of every head a CTA row, 64 queries a CTA."""
    plan, seen = _coverage(1, S, 16, 16, 256)
    assert (seen == 1).all() and plan.bq == 64 and plan.grid == (
        -(-S // 64), 16, 1)


def test_prefill_plan_refuses_groups_past_its_rows():
    with pytest.raises(ValueError, match="groups of 1 to 64"):
        FA.prefill_plan(1, 8, 128, 1, 256, True)
    assert FA.prefill_plan(1, 8, 128, 1, 128, True).bq == 1


def _inputs(seed, B, S, T, H, K, D, ends):
    """q/k/v from numpy normals; batch row b holds tokens 0..ends[b]-1 in
    its first slots, its query rows the last S of them (earlier rows and
    later slots are padding at 2**30)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, K, D)).astype(np.float32)
    v = rng.standard_normal((B, T, K, D)).astype(np.float32)
    q_pos = np.full((B, S), SENTINEL, np.int32)
    kv_pos = np.full((B, T), SENTINEL, np.int32)
    for b, n in enumerate(ends):
        kv_pos[b, :n] = np.arange(n)
        m = min(S, n)
        q_pos[b, S - m:] = np.arange(n - m, n)
    return q, k, v, q_pos, kv_pos


CASES = {  # name: (B, S, T, H, K, D, window, ends)
    "S300-window100-D64": (2, 300, 300, 4, 2, 64, 100, [300, 211]),
    "S300-window100-D128": (2, 300, 300, 4, 2, 128, 100, [300, 173]),
    "rows-of-1500-keys-D64": (1, 6, 1500, 4, 2, 64, 0, [1500]),
    "rows-of-1500-keys-D128": (1, 6, 1500, 4, 2, 128, 0, [1500]),
    "S300-window100-D256": (2, 300, 300, 4, 2, 256, 100, [300, 190]),
    "rows-of-1024-keys-D256": (1, 6, 1024, 4, 4, 256, 0, [1024]),
}


def _errors(name):
    B, S, T, H, K, D, window, ends = CASES[name]
    q, k, v, q_pos, kv_pos = _inputs(sum(map(ord, name)), B, S, T, H, K, D,
                                     ends)
    want = np.asarray(RA.chunked_attention(
        *(jnp.asarray(x) for x in (q, k, v, q_pos, kv_pos)), window=window))
    args = [torch.from_numpy(x) for x in (q, k, v, q_pos, kv_pos)]
    split = P_ref.prefill_tc_ref(*args, window=window)
    single = P_ref.prefill_tc_ref(*args, window=window, split=False)
    return (float(np.abs(split.numpy() - want).max()),
            float(np.abs(single.numpy() - want).max()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_3xtf32_holds_the_reference(name):
    err, _ = _errors(name)
    assert err < TOL, err


@pytest.mark.parametrize("name", sorted(CASES))
def test_single_tf32_pass_misses_the_reference(name):
    """The same inputs through one TF32 product each: past the 3e-5 bar."""
    _, err = _errors(name)
    assert err > TOL, err


def test_tf32_rounding():
    """Ties round away from zero, like cvt.rna; lo is truncated."""
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11),
                      1 + 2**-11 - 2**-20, 3.14159265])
    assert P_ref.tf32_round(x).tolist() == [
        1.0, 1 + 2**-10, 1 + 2**-9, -(1 + 2**-10), 1.0, 3.140625]
    assert P_ref.tf32_trunc(x).tolist() == [
        1.0, 1.0, 1 + 2**-10, -1.0, 1.0, 3.140625]


def test_empty_row_gives_zero():
    """A query row with no valid key: -1e30 scores, l floored, output 0."""
    q, k, v, q_pos, kv_pos = _inputs(3, 2, 20, 20, 4, 2, 32, [20, 9])
    kv_pos[1] = SENTINEL
    q_pos[1] = 0
    args = [torch.from_numpy(x) for x in (q, k, v, q_pos, kv_pos)]
    out = P_ref.prefill_tc_ref(*args)
    assert not out[1].any()
    plain = P_ref.chunked_attention_ref(*args)
    assert float((out - plain).abs().max()) < TOL
