"""K3 over the reference's whole range of head dims and GQA groups, on the
CPU.

The reference's attention takes any head dim and any group: its Pallas
kernel (``src/repro/kernels/flash_attention.py``) and its serving contract
``models/attention.py::chunked_attention``.  The port's kernels run every
head dim D that is a multiple of 8 up to 512 in the template of its tile
width (``flash_attention.tile_width``: 72 -> 96, 224 -> 256, 512), and
every group G (a prefill CTA takes a slice of a group's heads where the
group outgrows its rows).  Here, on numpy inputs from a seed:

- the port's attention (its plain versions on the CPU, and the plain
  emulations of the two kernels' algorithms: ``ref.split_decode_ref`` at
  ``decode_plan``'s splits, ``ref.prefill_tc_ref`` at ``prefill_plan``'s
  key tiles) against ``chunked_attention`` and the Pallas kernel (in
  interpret mode, as tests/test_kernels.py runs it) at D 72, 224 and 512,
  G 1, 64 and 128, causal, window 128 and non-causal, decode (S = 1) and
  prefill, f32 at 3e-5 and bf16 at 2e-2;
- the layouts, in pure Python: every (query, head) row of a prefill in
  exactly one CTA row of one grid (one launch) at G 71 and G 128 and at
  D 512, every key in one tile, every head of a decode in one head group
  of an instantiated size, the tile widths' zero columns;
- two-layer models from ``dataclasses.replace`` of reduced tinyllama at the
  three published attention shapes (Zamba2-7B's 32/32 heads at D 224,
  DeepSeek-V4-Flash's 64 heads over one kv head at D 512 under a 128-token
  window, DeepSeek-V4-Pro's 128 over one at D 512), through both Engines
  on the reference's weights: tokens, stats and stored pages equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_families import _drain, _same_store, _step, both_params
from repro.configs import get_reduced as R_get_reduced
from repro.kernels import ops as R_ops
from repro.models import attention as RA
from repro.serve.engine import Engine as REngine
from repro.serve.engine import Request as RRequest
from repro_torch.configs import get_reduced as P_get_reduced
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as P_ops
from repro_torch.kernels import ref as P_ref
from repro_torch.serve.engine import Engine as PEngine
from repro_torch.serve.engine import Request

TOL = {"f32": 3e-5, "bf16": 2e-2}       # tests/test_kernels.py's bars
SENTINEL = 2**30
N_SM = 132                              # the H100's SMs (decode_plan)
HEAD_DIMS = (72, 224, 512)
GROUPS = (1, 64, 128)
MASKS = {"causal": (True, 0), "window128": (True, 128),
         "noncausal": (False, 0)}
S_PREFILL, T = 16, 136                  # T past the window


def _kv_heads(G):
    return 2 if G == 1 else 1


def _arrays(seed, B, S, H, K, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, K, D)).astype(np.float32)
    v = rng.standard_normal((B, T, K, D)).astype(np.float32)
    return q, k, v


def _positions(B, S, ends):
    """Batch row b holds tokens 0..ends[b]-1 in its first slots (later
    slots at 2**30), its query rows the last S of them."""
    q_pos = np.full((B, S), SENTINEL, np.int32)
    kv_pos = np.full((B, T), SENTINEL, np.int32)
    for b, n in enumerate(ends):
        kv_pos[b, :n] = np.arange(n)
        q_pos[b] = np.arange(n - S, n)
    return q_pos, kv_pos


def _both(x, dt):
    """One numpy array as the reference's and the port's input of dtype
    ``dt`` (bf16 rounded once, to nearest even, on both sides)."""
    if dt == "bf16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
            torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _err(got, want):
    return float(np.abs(got.float().numpy() - np.asarray(
        want, np.float32)).max())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("S", [1, S_PREFILL], ids=["decode", "prefill"])
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_chunked_attention_matches_the_reference(D, G, mask, S, dt):
    """The port's ``ops.chunked_attention`` against the reference's
    ``models/attention.py::chunked_attention`` on the serving layout, with
    padded slots past the tokens; in f32 under the causal mask also the
    plain emulation of the kernel that path launches on the card, at its
    own layout (decode_plan's splits, prefill_plan's key tiles)."""
    causal, window = MASKS[mask]
    K = _kv_heads(G)
    B, H = 1, K * G
    q, k, v = _arrays(D * 1000 + G * 10 + S, B, S, H, K, D)
    qp, kp = _positions(B, S, [T - 5])
    rq, pq = _both(q, dt)
    rk, pk = _both(k, dt)
    rv, pv = _both(v, dt)
    want = RA.chunked_attention(rq, rk, rv, jnp.asarray(qp), jnp.asarray(kp),
                                causal=causal, window=window)
    pqp, pkp = torch.from_numpy(qp), torch.from_numpy(kp)
    got = P_ops.chunked_attention(pq, pk, pv, pqp, pkp, causal=causal,
                                  window=window)
    assert got.dtype == pq.dtype and got.shape == (B, S, H, D)
    assert _err(got, want) < TOL[dt]
    if dt == "bf16" or mask != "causal":
        return
    if S == 1:
        _, _, n_split, split_len = FA.decode_plan(B, K, G, T, 4, N_SM, D)
        twin = P_ref.split_decode_ref(pq, pk, pv, pqp, pkp, n_split=n_split,
                                      split_len=split_len, causal=causal,
                                      window=window)
    else:
        plan = FA.prefill_plan(B, S, H, K, D, True, D)
        twin = P_ref.prefill_tc_ref(pq, pk, pv, pqp, pkp, causal=causal,
                                    window=window, keys=plan.keys)
    assert _err(twin, want) < TOL[dt]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("S", [1, S_PREFILL], ids=["decode", "prefill"])
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_attention_matches_pallas(D, G, S, dt):
    """The port's ``ops.flash_attention`` (the reference kernel's own
    layout: q rows at the tail of the kv sequence) against the Pallas
    kernel in interpret mode; the mask goes round the three by shape."""
    causal, window = MASKS[sorted(MASKS)[(D + G + S) % 3]]
    K = _kv_heads(G)
    q, k, v = _arrays(D + G + S, 1, S, K * G, K, D)
    rq, pq = _both(q.transpose(0, 2, 1, 3).copy(), dt)
    rk, pk = _both(k.transpose(0, 2, 1, 3).copy(), dt)
    rv, pv = _both(v.transpose(0, 2, 1, 3).copy(), dt)
    want = R_ops.flash_attention(rq, rk, rv, causal=causal, window=window,
                                 block_q=64, block_k=64)
    got = P_ops.flash_attention(pq, pk, pv, causal=causal, window=window)
    assert got.dtype == pq.dtype and tuple(got.shape) == tuple(want.shape)
    assert _err(got, want) < TOL[dt]


# ---------------------------------------------------------------- layouts

def _prefill_coverage(B, S, H, K, D, f32):
    """How many CTA rows of ``prefill_plan``'s one grid compute each
    (batch, query, head), walked through ``prefill_row``."""
    plan = FA.prefill_plan(B, S, H, K, D, f32, D)
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


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("G,D", [(71, 72), (71, 224), (71, 512), (128, 72),
                                 (128, 224), (128, 512), (64, 512),
                                 (1, 512), (3, 512)])
@pytest.mark.parametrize("S", [1, 37, 300])
def test_prefill_plan_covers_every_row_once(S, G, D, f32):
    """One grid (one launch) gives every (query, head) row of q to exactly
    one CTA row, whatever the group: a group past a CTA's rows (32 at
    width 512, 64 at 256, 128 below) is cut into slices of ``heads``;
    every key lies in one tile of ``keys`` (32 at width 512)."""
    K = 2
    plan, seen = _prefill_coverage(1, S, K * G, K, D, f32)
    assert (seen == 1).all()
    width = FA.tile_width(D)
    wgmma = not f32 and width in (64, 128, 256)       # the all-bf16 route
    rows = 128 if wgmma else {512: 32, 256: 64}.get(width, 128)
    assert (plan.rows, plan.width, plan.heads) == (rows, width, min(G, rows))
    assert plan.route == ("wgmma" if wgmma else "mma")
    assert plan.keys == (FA.WGMMA_KEYS[width] if wgmma
                         else 32 if width == 512 else 64)
    assert plan.stages == (1 if f32 and width > 128 else 2)
    n_slices = -(-G // plan.heads)
    assert plan.grid[0] == -(-S // plan.bq) * n_slices
    keys = np.zeros(S + D, np.int64)
    for t0 in range(0, S + D, plan.keys):
        keys[t0:t0 + plan.keys] += 1
    assert (keys == 1).all()


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("D", [8, 40, 72, 96, 136, 224, 264, 512])
@pytest.mark.parametrize("G", [1, 3, 64, 71, 128])
def test_decode_plan_covers_every_head_once(G, D, itemsize):
    """The split-KV kernel's layout at every tile width: a head group of
    an instantiated size (2, 4 or 8; 2 where a lane holds more than 16
    floats of a head), every head of a kv head in exactly one of its
    ``n_groups`` CTAs, a lane's floats times its lanes the tile's width
    with the lanes of a row a power of two (the kernel's static check)."""
    B, K, T_ = 3, 2, 1000
    gc, n_groups, n_split, split_len = FA.decode_plan(B, K, G, T_, itemsize,
                                                      N_SM, D)
    width = FA.tile_width(D)
    f = FA._lanes(width, 16 // itemsize)
    lanes = width // f
    assert lanes * f == width and 32 % lanes == 0
    assert gc in (2, 4, 8) and (gc * f <= 32 or gc == 2)
    heads = [hg * gc + i for hg in range(n_groups) for i in range(gc)
             if hg * gc + i < G]
    assert heads == list(range(G))
    assert n_split * split_len >= T_ > (n_split - 1) * split_len


@pytest.mark.parametrize("pair", ["f32", "bf16-q", "bf16", "int8"])
@pytest.mark.parametrize("D", [64, 72, 128, 224, 256, 512])
@pytest.mark.parametrize("G", [1, 3, 8, 64, 128])
def test_decode_layout_form_at_every_head_shape(G, D, pair):
    """The decode kernel's form by shape: the cluster form exactly where
    its (q dtype, K/V dtype, head dim, head group) is instantiated
    (CLUSTER_DECODE: never at the padded 72 and 224 nor at 512), with the
    split form's head group and every head of a kv head in one of its
    groups; else the split form, decode_plan's layout unchanged."""
    qd, kd = {"f32": (torch.float32, torch.float32),
              "bf16-q": (torch.bfloat16, torch.float32),
              "bf16": (torch.bfloat16, torch.bfloat16),
              "int8": (torch.float32, torch.int8)}[pair]
    B, K, T_ = 3, 2, 1000
    plan = FA.decode_layout(B, K, G, T_, qd, kd, N_SM, D)
    itemsize = torch.empty((), dtype=kd).element_size()
    split = FA.decode_plan(B, K, G, T_, itemsize, N_SM, D)
    assert plan.head_group == split[0] and plan.n_groups == split[1]
    cluster = (qd, kd, D, plan.head_group) in FA.CLUSTER_DECODE
    assert plan.form == ("cluster" if cluster else "split")
    if D not in (64, 128, 256):
        assert plan.form == "split"
    if plan.form == "split":
        assert plan[1:5] == split
    else:
        assert plan.n_split <= FA.CLUSTER_MAX
        assert (plan.n_split - 1) * plan.split_len < T_ <= (
            plan.n_split * plan.split_len)
    heads = [hg * plan.head_group + i for hg in range(plan.n_groups)
             for i in range(plan.head_group) if hg * plan.head_group + i < G]
    assert heads == list(range(G))


def test_tile_widths():
    """Each head dim that is a multiple of 8 from 8 to 512 runs in its own
    width where it is an unpadded one (the old five widths and 512), else
    in the smallest padded width at or above it (96 in its own, padded);
    at the named shapes the zero columns are at most a quarter of the
    tile; anything else raises, naming its ROADMAP row."""
    for d in range(8, 513, 8):
        w = FA.tile_width(d)
        if d in FA.TILE_WIDTHS:
            assert w == d
        else:
            assert w in FA.PADDED_WIDTHS and w >= d
            assert all(x < d for x in FA.PADDED_WIDTHS if x < w)
    for d, w in ((72, 96), (224, 256), (512, 512)):
        assert FA.tile_width(d) == w and (w - d) * 4 <= w
    for d in (16, 32, 64, 96, 128, 256, 512):
        assert FA.tile_width(d) == d
    assert 96 not in FA.TILE_WIDTHS
    for d in (0, 4, 100, 520, 1024):
        with pytest.raises(ValueError, match="K3f"):
            FA.tile_width(d)


def test_library_name_hashes_its_compiler_flags(monkeypatch):
    """A kernel library's file name changes with the nvcc flags as with
    its source, so a library built under other flags is never loaded."""
    from repro_torch.kernels import _build

    name = _build._target("flash_attention")
    assert _build._target("flash_attention") == name
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        [f for f in _build.NVCC_FLAGS
                         if not f.startswith("--split-compile")])
    assert _build._target("flash_attention") != name


# ------------------------------------------------- models through Engines

SHAPES = {  # name: (n_heads, n_kv_heads, head_dim, window)
    "zamba2-7b-attention": (32, 32, 224, 0),
    "deepseek-v4-flash-attention": (64, 1, 512, 128),
    "deepseek-v4-pro-attention": (128, 1, 512, 0),
}
# (max_len, prompt lengths): past the window where there is one; short
# where 32 kv heads make a snapshot large (1.8 MB of pages at max_len 16),
# each page moved by the reference's page kernels in interpret mode
SERVE = {"zamba2-7b-attention": (16, (5, 9)),
         "deepseek-v4-flash-attention": (144, (130, 9)),
         "deepseek-v4-pro-attention": (48, (9, 30))}


def _config(get_reduced, name):
    H, K, D, window = SHAPES[name]
    return dataclasses.replace(
        get_reduced("tinyllama-1.1b"), n_layers=2, n_heads=H, n_kv_heads=K,
        head_dim=D, window=window, swa_period=2 if window else 0)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_engines_serve_the_published_attention_shapes(name):
    """Two layers of reduced tinyllama at a published attention shape
    (under DeepSeek-V4-Flash's window, layer 0 local and layer 1 global),
    the same ``replace`` on both packages' configs, served by both Engines
    on the reference's weights: prompts prefilled in buckets (past the
    window where there is one), a suspend wave, a resume wave, the rest
    drained; greedy tokens step by step, stats and every stored snapshot
    equal."""
    rcfg = _config(R_get_reduced, name)
    pcfg = _config(P_get_reduced, name)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(rcfg)
    rparams, pparams = both_params(rcfg, seed=3)
    max_len, lens = SERVE[name]
    kw = dict(slots=2, max_len=max_len, n_sessions=4)
    r, p = REngine(rcfg, rparams, **kw), PEngine(pcfg, pparams, device="cpu",
                                                 **kw)
    assert p.page_spec.leaf_shapes == r.page_spec.leaf_shapes
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, rcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    reqs = []
    for uid, prompt in enumerate(prompts):
        rq, pq = RRequest(uid, prompt, 6), Request(uid, prompt, 6)
        assert r.submit(rq) == p.submit(pq)
        reqs.append((rq, pq))
    for _ in range(2):
        _step(r, p)
    r.suspend_many([0, 1]), p.suspend_many([0, 1])
    _same_store(r, p)
    r.resume_many([0, 1], [4, 4]), p.resume_many([0, 1], [4, 4])
    _drain(r, p)
    for rq, pq in reqs:
        assert pq.generated == rq.generated
    assert p.stats == r.stats and p.stats["resumes"] == 2
    _same_store(r, p)
    assert p.verify_failure_count() == r.verify_failure_count() == 0
