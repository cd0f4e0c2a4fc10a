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

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
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
    plan = FA.prefill_plan(B, S, H, K, head_dim, f32, head_dim)
    G = H // K
    nq, nk, nb = plan.grid
    assert (nk, nb) == (K, B) and plan.bq * plan.heads <= plan.rows
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
    """Head dim 256 (gemma-7b): on the f32 path (q or K/V f32) two warps
    share each 16-row block, so a CTA holds 64 rows, with one K/V stage;
    all-bf16 runs the wgmma route: 128 rows (two warpgroups of 64), 64-key
    tiles, two stages.  Every (query, head) row once, G = 64 at one or two
    queries a CTA, and the head dim read once by the f32 fragment order
    (eight k-blocks)."""
    K = 2
    plan, seen = _coverage(2, S, K * G, K, 256, f32)
    assert (seen == 1).all()
    rows = 64 if f32 else 128
    assert (plan.rows, plan.keys, plan.stages) == (rows, 64, 1 if f32 else 2)
    assert plan.route == ("mma" if f32 else "wgmma")
    assert plan.bq == rows // G
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


@pytest.mark.parametrize("G,D", [(65, 256), (128, 256), (129, 128),
                                 (300, 64)])
def test_prefill_plan_slices_groups_past_its_rows(G, D):
    """A group larger than a CTA's rows (64 at head dim 256, 128 below) is
    cut into ceil(G / rows) slices of ``heads`` = rows heads, one query a
    CTA: every (query, head) row once, on one grid (one launch)."""
    K, S = 2, 37
    plan, seen = _coverage(2, S, K * G, K, D)
    assert (seen == 1).all()
    rows = 64 if D > 128 else 128
    assert (plan.rows, plan.heads, plan.bq) == (rows, rows, 1)
    assert plan.grid == (S * -(-G // rows), K, 2)
    assert FA.prefill_plan(1, 8, 128, 1, 128, True, 128).bq == 1


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


# ---- the all-bf16 route (csrc/flash_prefill_wgmma.cu) ---------------------

DTYPE_PAIRS = [(torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32),
               (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("qd,kd", DTYPE_PAIRS)
def test_prefill_route_by_dtypes_and_head_dims(qd, kd):
    """The route table: all-bf16 q, k and v at tile widths 64, 128 and 256
    (Zamba2's 224, and 8 or 24, padded to 64, among them) and at MLA's Dk 192
    / Dv 128 run the wgmma kernel; f32, mixed dtypes and widths 16, 32, 96
    and 512 keep the mma.sync kernel; other head dims raise."""
    bf16 = qd == kd == torch.bfloat16
    for D in range(8, 513, 8):
        wg = bf16 and FA.tile_width(D) in (64, 128, 256)
        assert FA.prefill_route(qd, kd, D, D) == ("wgmma" if wg else "mma")
    assert FA.prefill_route(qd, kd, 192, 128) == (
        "wgmma" if bf16 else "mma")
    for D in (8, 24, 56, 64, 120, 128, 136, 224, 256):
        assert FA.prefill_route(qd, kd, D, D) == ("wgmma" if bf16 else "mma")
    for D in (16, 32, 72, 96, 264, 512):
        assert FA.prefill_route(qd, kd, D, D) == "mma"
    for dk, dv in ((192, 64), (128, 64), (520, 520), (12, 12)):
        with pytest.raises(ValueError):
            FA.prefill_route(qd, kd, dk, dv)


def _wgmma_coverage(B, S, H, K, dk, dv):
    plan = FA.prefill_plan(B, S, H, K, dk, False, dv)
    G = H // K
    nx, nk, nb = plan.grid
    assert (nk, nb) == (K, B) and plan.bq * plan.heads <= plan.rows
    seen = np.zeros((B, S, H), np.int64)
    for x in range(nx):
        for kvh in range(K):
            for r in range(plan.rows):
                got = FA.prefill_row(plan, S, G, x, kvh, r)
                if got is not None:
                    s, h = got
                    assert h // G == kvh
                    seen[:, s, h] += 1
    return plan, seen


@pytest.mark.parametrize("D", [56, 64, 120, 128, 224, 256, "mla"])
@pytest.mark.parametrize("G", [1, 2, 3, 8, 16, 32])
@pytest.mark.parametrize("S", [2, 37, 300, 1025])
def test_wgmma_plan_covers_every_row_once(S, G, D):
    """The wgmma route's layout: 128 rows a CTA (two warpgroups of 64),
    ``heads`` = min(G, 128) heads of one kv head a CTA, BQ = 128 // heads
    queries; every (query, head) row of q to exactly one CTA row for S not
    a multiple of BQ and G that does not divide 128; every key in one tile
    of its width's keys (64 at 256, else 128)."""
    dk, dv = FA.MLA_DIMS if D == "mla" else (D, D)
    K = 2
    plan, seen = _wgmma_coverage(2, S, K * G, K, dk, dv)
    assert (seen == 1).all()
    width = FA.MLA_DIMS[0] if D == "mla" else FA.tile_width(D)
    assert plan.route == "wgmma" and plan.width == width
    assert (plan.rows, plan.heads, plan.bq) == (128, G, 128 // G)
    assert plan.keys == FA.WGMMA_KEYS[width] == (64 if width == 256
                                                 else 128)
    assert plan.stages == FA.WGMMA_STAGES[width]
    assert plan.grid == (-(-S // plan.bq), K, 2)
    T = S + 5
    keys = np.zeros(T, np.int64)
    for t0 in range(0, T, plan.keys):
        keys[t0:min(T, t0 + plan.keys)] += 1
    assert (keys == 1).all()


@pytest.mark.parametrize("G,D", [(129, 128), (200, 64), (300, 256)])
def test_wgmma_plan_slices_groups_past_its_rows(G, D):
    """A group past 128 heads is cut into ceil(G / 128) slices of 128 heads,
    one query a CTA, on one grid; every row once."""
    K, S = 2, 9
    plan, seen = _wgmma_coverage(1, S, K * G, K, D, D)
    assert (seen == 1).all()
    assert (plan.rows, plan.heads, plan.bq) == (128, 128, 1)
    assert plan.grid == (S * -(-G // 128), K, 1)
