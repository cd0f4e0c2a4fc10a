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


# ---- the short form of the f32 path (prefill_short_kernel) ----------------

N_SM = 132                        # an H100's SMs (the wrapper asks the card)
# the CTAs of the short form an H100 80GB HBM3 holds an SM at 64, 32 and 16
# rows a CTA (FA.SHORT_ROWS), by (Dk, Dv), as its occupancy calculator gave
# them (flash_prefill_short_per_sm, T 64 to 512): the shared memory binds,
# 2-3 CTAs at D 64 and MLA's 32 or 16 rows, else 1
H100_PER_SM = {(64, 64): (2, 2, 3), (128, 128): (1, 1, 1),
               (256, 256): (1, 1, 1), (192, 128): (1, 2, 2)}
# name: (S, T, H, K, Dk, Dv, the form prefill_plan takes on N_SM SMs): the
# serving paths' f32 and mixed prefills, by bucket; bf16 q over f32 K/V
# (a name with "mixed") keeps the full form at every bucket
SHORT_SHAPES = {
    **{f"tinyllama-{s}": (s, s, 32, 4, 64, 64, "short" if s < 512 else "full")
       for s in (16, 32, 64, 128, 256, 512)},
    **{f"gemma-7b-{s}": (s, s, 16, 16, 256, 256,
                         "short" if s <= 256 else "full")
       for s in (16, 64, 128, 256, 512, 1024)},
    "olmoe-1024": (1024, 1024, 16, 16, 128, 128, "full"),
    "olmoe-64": (64, 64, 16, 16, 128, 128, "short"),
    "gemma3-1500": (1500, 1500, 32, 16, 128, 128, "full"),
    "gemma3-128": (128, 128, 32, 16, 128, 128, "short"),
    "mla-64": (64, 64, 128, 128, 192, 128, "short"),
    "mla-1024": (1024, 1024, 128, 128, 192, 128, "full"),
    "qwen1.5-mixed-32": (32, 32, 64, 8, 128, 128, "full"),
    "qwen1.5-mixed-256": (256, 256, 64, 8, 128, 128, "full"),
    "seamless-cross-16x4096": (16, 4096, 16, 16, 64, 64, "full"),
}


def _short_plan(S, T, H, K, dk, dv, B=1, lse=False, mixed=False,
                rows=None):
    return FA.prefill_plan(B, S, H, K, dk, True, dv, T=T, n_sm=N_SM,
                           lse=lse, mixed=mixed,
                           per_sm=H100_PER_SM.get((dk, dv)), short_rows=rows)


def _cell_coverage(plan, B, S, H, K, dv):
    """How many CTA rows compute each (batch, query, head, output column):
    the grid walked through ``prefill_row`` and ``prefill_cols``."""
    G = H // K
    nx, nk, nb = plan.grid
    assert (nk, nb) == (K, B) and plan.bq * plan.heads <= plan.rows
    seen = np.zeros((B, S, H, dv), np.int64)
    for x in range(nx):
        lo, hi = FA.prefill_cols(plan, x, dv)
        for kvh in range(K):
            for r in range(plan.rows):
                got = FA.prefill_row(plan, S, G, x, kvh, r)
                if got is not None:
                    s, h = got
                    assert h // G == kvh
                    seen[:, s, h, lo:hi] += 1
    return seen


@pytest.mark.parametrize("name", sorted(SHORT_SHAPES))
def test_short_form_covers_every_cell_once(name):
    """At the serving paths' shapes, the plan on an H100's 132 SMs takes
    the short form where its criterion says (the full grid at most half a
    wave, or its rows half empty; at most 512 keys), and either form gives
    every (query, head, output column) to exactly one CTA row: at Dv 256
    the short form's two CTAs of a query block each write one half."""
    S, T, H, K, dk, dv, form = SHORT_SHAPES[name]
    plan = _short_plan(S, T, H, K, dk, dv, mixed="mixed" in name)
    assert plan.form == form and plan.route == "mma"
    assert (_cell_coverage(plan, 1, S, H, K, dv) == 1).all()
    if form == "short":
        G = H // K
        assert plan.rows in FA.SHORT_ROWS and plan.heads == G
        assert plan.bq == plan.rows // G
        assert plan.halves == (2 if dv == 256 else 1)
        assert plan.grid[0] == -(-S // plan.bq) * plan.halves
        assert (plan.keys, plan.stages) == (64, 1 if dk > 128 else 2)


@pytest.mark.parametrize("name", sorted(SHORT_SHAPES))
def test_full_form_kept_outside_the_criterion_and_with_lse(name):
    """Where the criterion does not take a shape, and for every shape when
    ``lse`` is asked for (K3e's forward), the plan is the one laid out
    without the SM count, bit for bit; so is every plan of bf16 q over f32
    K/V (``mixed``), even at a forced row count, and every all-bf16
    (wgmma) plan."""
    S, T, H, K, dk, dv, form = SHORT_SHAPES[name]
    today = FA.prefill_plan(1, S, H, K, dk, True, dv)
    assert today.form == "full" and today.halves == 1
    if form == "full":
        assert _short_plan(S, T, H, K, dk, dv, mixed="mixed" in name) == today
    assert _short_plan(S, T, H, K, dk, dv, lse=True) == today
    assert _short_plan(S, T, H, K, dk, dv, mixed=True) == today
    assert _short_plan(S, T, H, K, dk, dv, mixed=True, rows=64) == today
    assert FA.prefill_plan(1, S, H, K, dk, False, dv, T=T,
                           n_sm=N_SM) == FA.prefill_plan(1, S, H, K, dk,
                                                         False, dv)


@pytest.mark.parametrize("G,D", [(65, 128), (1, 96), (2, 224), (4, 32)])
def test_short_form_only_whole_groups_at_its_widths(G, D):
    """A group past 64 heads, a padded head dim (96, Zamba2's 224) and a
    width the short form has no template of keep the full form."""
    plan = _short_plan(16, 16, 2 * G, 2, D, D)
    assert plan == FA.prefill_plan(1, 16, 2 * G, 2, D, True, D)


@pytest.mark.parametrize("B,S,H,K,D", [
    (1, 64, 16, 16, 256), (1, 128, 16, 16, 256), (1, 256, 16, 16, 256),
    (3, 40, 16, 16, 256), (1, 16, 32, 4, 64), (1, 256, 32, 4, 64),
    (2, 16, 32, 4, 64), (1, 200, 24, 3, 64), (1, 64, 128, 128, 192),
    (1, 128, 32, 16, 128), (2, 64, 128, 128, 192), (4, 64, 128, 128, 192),
    (8, 64, 128, 128, 192)])
def test_short_form_rows_per_cta(B, S, H, K, D):
    """The rows a CTA: the fewest of 16, 32, 64 among those whose grid
    takes the fewest waves (a wave 132 SMs times the CTAs an SM holds at
    that many rows): the fewest whose grid fits one wave where any does.  On
    an H100: gemma-7b's bucket 64, 16 rows, 4 query blocks x 2 halves x 16
    heads = 128 CTAs (the full form's 16); its bucket 128, 32 rows (16
    would take two waves); its bucket 256, 64 rows; MLA's bucket 64, 32
    rows, two CTAs an SM, and at B 2-8, where no count fits a wave, 32
    rows still (as many waves as 64 rows, at two CTAs an SM); tinyllama's
    bucket 256, 32 rows."""
    dv = 128 if D == 192 else D
    plan = _short_plan(S, S, H, K, D, dv, B=B)
    G, halves = H // K, 2 if dv == 256 else 1
    occ = dict(zip(FA.SHORT_ROWS, H100_PER_SM[(D, dv)]))
    fits = sorted(r for r in FA.SHORT_ROWS if r >= G)

    def waves(r, per):
        return -(-(-(-S // (r // G)) * halves * K * B) // (N_SM * per))
    least = min(waves(r, occ[r]) for r in fits)
    want = next(r for r in fits if waves(r, occ[r]) == least)
    assert plan.form == "short" and plan.rows == want
    named = {(1, 64, 16, 16, 256): (16, (8, 16, 1)),
             (1, 128, 16, 16, 256): (32, (8, 16, 1)),
             (1, 256, 16, 16, 256): (64, (8, 16, 1)),
             (1, 64, 128, 128, 192): (32, (2, 128, 1)),
             (2, 64, 128, 128, 192): (32, (2, 128, 2)),
             (8, 64, 128, 128, 192): (32, (2, 128, 8)),
             (1, 256, 32, 4, 64): (32, (64, 4, 1))}
    if (B, S, H, K, D) in named:
        assert (plan.rows, plan.grid) == named[(B, S, H, K, D)]
    # without the card's occupancy, one CTA an SM
    one = FA.prefill_plan(B, S, H, K, D, True, dv, T=S, n_sm=N_SM)
    least = min(waves(r, 1) for r in fits)
    want = next(r for r in fits if waves(r, 1) == least)
    assert one.form == "short" and one.rows == want


def _short_inputs(seed, B, S, T, H, K, dk, dv, ends, qdt=np.float32):
    """q/k/v from numpy normals at ``dk``/``dv``; batch row b holds tokens
    0..ends[b]-1 and pads at 2**30 (the Engine's bucket), its query 0 of
    batch row 0 at position -1, a row with no valid key."""
    q, k, _, q_pos, kv_pos = _inputs(seed, B, S, T, H, K, dk, ends)
    rng = np.random.default_rng(seed + 1)
    v = rng.standard_normal((B, T, K, dv)).astype(np.float32)
    q_pos[0, 0] = -1
    return q.astype(qdt), k, v, q_pos, kv_pos


SHORT_CASES = {  # name: (B, S, T, H, K, D, window, ends)
    "D256-bucket64-40-tokens": (2, 64, 64, 4, 4, 256, 0, [40, 64]),
    "D256-window-20": (2, 64, 64, 4, 2, 256, 20, [64, 23]),
    "D256-two-tiles": (1, 128, 128, 2, 2, 256, 0, [100]),
    "D64-G8-bucket16": (2, 16, 16, 16, 2, 64, 0, [16, 9]),
    "D128-three-tiles-window": (1, 150, 150, 8, 4, 128, 50, [150]),
    # gemma3's bucket 128 (96 tokens, G 2) and olmoe's bucket 64 (40, MHA)
    # at D 128, fewer heads
    "D128-G2-bucket128-96-tokens": (1, 128, 128, 4, 2, 128, 0, [96]),
    "D128-bucket64-window-24": (2, 64, 64, 2, 2, 128, 24, [40, 64]),
}


@pytest.mark.parametrize("rows", [None, 32, 64])
@pytest.mark.parametrize("name", sorted(SHORT_CASES))
def test_short_form_emulation_holds_the_reference(name, rows):
    """``ref.prefill_short_ref``, CTA by CTA as the short form computes
    (its rows, its output half, Q scaled as the kernel scales it, each
    warp's keys of a tile apart, then combined), against the reference's
    ``chunked_attention`` at 3e-5: head dim 256 in halves, ragged pads at
    2**30, a window, T past one tile, and a row with no valid key (0); at
    the plan's rows (16 at these shapes: four warps a row block) and at
    32 and 64 (two, one)."""
    B, S, T, H, K, D, window, ends = SHORT_CASES[name]
    q, k, v, q_pos, kv_pos = _short_inputs(sum(map(ord, name)), B, S, T, H,
                                           K, D, D, ends)
    plan = _short_plan(S, T, H, K, D, D, B=B, rows=rows)
    assert plan.form == "short"
    assert (_cell_coverage(plan, B, S, H, K, D) == 1).all()
    want = np.asarray(RA.chunked_attention(
        *(jnp.asarray(x) for x in (q, k, v, q_pos, kv_pos)), window=window))
    got = P_ref.prefill_short_ref(
        *(torch.from_numpy(x) for x in (q, k, v, q_pos, kv_pos)), plan,
        window=window)
    assert float(np.abs(got.numpy() - want).max()) < TOL
    assert not got[0, 0].any()


@pytest.mark.parametrize("rows", [16, 32, 64])
def test_short_form_rows_forced_and_refused(rows):
    """``short_rows`` lays out the short form at that many rows a CTA where
    the criterion would not (gemma-7b's bucket 512, between half a wave and
    one) and the same layout the criterion picks where it picks that many;
    fewer rows than a whole group, or a count it has no instantiation of,
    is refused."""
    plan = _short_plan(512, 512, 16, 16, 256, 256, rows=rows)
    assert plan.form == "short" and plan.rows == rows
    assert plan.bq == rows and plan.grid == (-(-512 // rows) * 2, 16, 1)
    assert (_cell_coverage(plan, 1, 512, 16, 16, 256) == 1).all()
    picked = _short_plan(64, 64, 16, 16, 256, 256)
    assert _short_plan(64, 64, 16, 16, 256, 256, rows=picked.rows) == picked
    if rows < 64:                                   # a group of 64 heads
        with pytest.raises(ValueError):
            _short_plan(16, 16, 64, 1, 64, 64, rows=rows)
    with pytest.raises(ValueError):                 # no such instantiation
        _short_plan(16, 16, 4, 4, 64, 64, rows=rows + 8)
