"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a GPU (decided in the fixture, at
run time).  On a machine with one, run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

They cover shapes the smoke run does not: odd page counts, masked and out-
of-range page tables, tables longer than the page gather's persistent grid
and mostly -1 (a hop's), pages of 16 B to 64 KiB, the all-bf16 prefill
route (csrc/flash_prefill_wgmma.cu) at each of its widths, other head dims
(256 included), group sizes and dtypes (q over k/v of another dtype
included), sequence lengths that are not multiples of the kernels' tiles
or splits, the decode kernel's dispatch rule, its cluster form
(``decode_layout``'s form "cluster") at every instantiation, at T off its
splits and shorter than one, with dead splits and rows, a window and views
off 16-byte boundaries, int8 K/V with their scales on the decode route
(K3d) at every instantiated head dim and group, and the Engine on the card
against the Engine on the CPU (the dense, sliding-window, MoE, MLA and
recurrent families), and the mesh's split train, prefill and decode steps
(MLA's and rwkv's among them) on the card against the CPU, and the entry-
point audit's card checks (syncs, launches, allocations), and the
roofline's profile capture (every launch of its region recorded)."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_within_bar(out, want, q, k, v, qp, kp, *, window=0,
                       causal=True):
    """K3's output against the plain ``want`` under ref.attention_bar:
    3e-5 where it is f32; where it is bf16, the rounding of the same f32
    result (and the prefill's bf16 P), never past 2e-2."""
    bar = ref.attention_bar(out, want, q, k, v, qp, kp, causal=causal,
                            window=window)
    assert out.dtype == want.dtype
    assert bool(((out.float() - want.float()).abs() < bar).all())


def _hold_k3e(q, k, v, qp, kp, up, *, causal=True, window=0):
    """K3e under grad: the forward one prefill launch within the bar of the
    plain twin; the backward once a call, in the kernel's counter where
    ``backward_route`` gives the kernel, else in the recompute's (where dq,
    dk and dv equal the twin's autograd gradients); two calls bit-equal;
    and each of dq, dk and dv, in its input's dtype and finite, within 2x
    the relative L2 gap of the twin's own gradients (in the inputs' dtypes,
    over one block of all keys) to the twin's in f64.  Returns (output,
    gradients, the twin's gradients)."""
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    twins = [t.clone().requires_grad_() for t in (q, k, v)]
    before = ops.launch_counts()
    out = ops.chunked_attention(*leaves, qp, kp, causal=causal,
                                window=window)
    assert out.grad_fn is not None and out.dtype == q.dtype
    want = ref.chunked_attention_ref(*twins, qp, kp, causal=causal,
                                     window=window, block=k.shape[1])
    _assert_within_bar(out.detach(), want.detach(), q, k, v, qp, kp,
                       window=window, causal=causal)
    got = torch.autograd.grad(out, leaves, up)
    again = torch.autograd.grad(
        ops.chunked_attention(*leaves, qp, kp, causal=causal,
                              window=window), leaves, up)
    counts = ops.launch_counts()
    grew = {n: counts[n] - before[n] for n in counts if counts[n] != before[n]}
    route = ops.FA.backward_route(q.dtype, k.dtype, q.shape[-1], v.shape[-1])
    name = ("flash_attention_backward" if route == "kernel"
            else "flash_attention_backward_plain")
    assert grew == {"flash_attention": 2, "flash_attention_prefill": 2,
                    name: 2,
                    **({"flash_attention_prefill_wgmma": 2}
                       if ops.FA.prefill_route(q.dtype, k.dtype, q.shape[-1],
                                               v.shape[-1]) == "wgmma"
                       else {})}
    exp = torch.autograd.grad(want, twins, up)
    f64 = ref.twin_grads_f64(q, k, v, qp, kp, up, causal=causal,
                             window=window)
    for a, b, e, x, t in zip(got, again, exp, f64, (q, k, v)):
        assert a.dtype == t.dtype and a.shape == t.shape
        assert torch.equal(a, b)
        assert bool(torch.isfinite(a.float()).all())
        assert ref.rel_l2(a, x) <= 2 * ref.rel_l2(e, x)
        if route == "recompute":
            assert torch.equal(a, e)
    return out, got, exp


@pytest.mark.parametrize("dt", [torch.uint8, torch.float32, torch.bfloat16,
                                torch.int8, torch.int32])
def test_gather_scatter_bit_exact(dev, dt):
    g = torch.Generator(device=dev).manual_seed(1)
    pages = torch.randn((777, 8, 128), device=dev, generator=g).mul(9).to(dt)
    upd = torch.randn((301, 8, 128), device=dev, generator=g).mul(9).to(dt)
    table = torch.randint(-1, 777, (301,), device=dev, generator=g,
                          dtype=torch.int32)
    got = ops.villa_scatter(pages.clone(), table, upd)
    want = ref.villa_scatter_ref(pages.clone(), table, upd)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    rtab = table.clamp(min=0)
    assert torch.equal(ops.villa_gather(pages, rtab).view(torch.uint8),
                       pages[rtab.long()].view(torch.uint8))
    out = torch.zeros_like(upd)
    ops.villa_gather(pages, table, out=out)
    assert torch.equal(out.view(torch.uint8),
                       ref.villa_gather_ref(pages, table, torch.zeros_like(
                           upd)).view(torch.uint8))
    with pytest.raises(IndexError):
        ops.villa_gather(pages, [777])


@pytest.mark.parametrize("B,S,T,H,K,D,dt", [
    (3, 1, 1000, 8, 2, 32, torch.float32),
    (2, 37, 37, 12, 4, 128, torch.float32),
    (1, 100, 130, 6, 6, 64, torch.float32),
    (2, 1, 77, 64, 1, 64, torch.float32),
    (2, 50, 50, 32, 4, 64, torch.bfloat16),
])
def test_attention_matches_plain(dev, B, S, T, H, K, D, dt):
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((B, S, H, D), device=dev, generator=g).to(dt)
    k = torch.randn((B, T, K, D), device=dev, generator=g).to(dt)
    v = torch.randn((B, T, K, D), device=dev, generator=g).to(dt)
    rng = np.random.default_rng(3)
    kv_pos = np.full((B, T), 2**30, np.int32)
    q_pos = np.zeros((B, S), np.int32)
    for b in range(B):
        n = int(rng.integers(S, T + 1))
        kv_pos[b, :n] = rng.permutation(n)            # any order of slots
        q_pos[b] = np.arange(n - S, n)
    qp, kp = torch.from_numpy(q_pos).to(dev), torch.from_numpy(kv_pos).to(dev)
    out = ops.chunked_attention(q, k, v, qp, kp)
    want = ref.chunked_attention_ref(q, k, v, qp, kp)
    _assert_within_bar(out, want, q, k, v, qp, kp)
    full = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=False)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=False)
    # the exact softmax scales q after promoting it: bf16's 2e-2
    tol = 2e-2 if dt == torch.bfloat16 else 3e-5
    assert float((full.float() - want.float()).abs().max()) < tol


@pytest.mark.parametrize("B,S,T,H,K,D,window,dt", [
    (4, 1, 1024, 32, 16, 128, 1024, torch.float32),   # gemma3's ring decode
    (4, 1, 64, 8, 2, 64, 48, torch.float32),          # ring longer than W
    (1, 300, 300, 32, 16, 128, 100, torch.float32),   # prefill past W
    (2, 77, 77, 6, 3, 32, 1, torch.float32),          # only the diagonal
    (4, 1, 1024, 32, 16, 128, 1024, torch.bfloat16),
    (1, 300, 300, 32, 16, 128, 100, torch.bfloat16),
])
def test_window_attention_matches_plain(dev, B, S, T, H, K, D, window, dt):
    """Sliding windows over ring caches whose positions wrapped (slot
    t % T holds token t, so positions are not monotone in the slot), and
    prefills with padded rows at 2**30."""
    g = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn((B, S, H, D), device=dev, generator=g).to(dt)
    k = torch.randn((B, T, K, D), device=dev, generator=g).to(dt)
    v = torch.randn((B, T, K, D), device=dev, generator=g).to(dt)
    rng = np.random.default_rng(7)
    if S == 1:
        kv_pos = np.full((B, T), 2**30, np.int32)
        ends = rng.integers(T // 2, 3 * T, B)
        for b, n in enumerate(ends):
            t = np.arange(max(0, n - T + 1), n + 1)
            kv_pos[b, t % T] = t
        q_pos = ends[:, None].astype(np.int32)
    else:
        q_pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        q_pos[-1, S - 9:] = 2**30
        kv_pos = q_pos.copy()
    qp, kp = torch.from_numpy(q_pos).to(dev), torch.from_numpy(kv_pos).to(dev)
    n = ops.KERNELS["flash_attention"].launches
    out = ops.chunked_attention(q, k, v, qp, kp, window=window)
    want = ref.chunked_attention_ref(q, k, v, qp, kp, window=window)
    _assert_within_bar(out, want, q, k, v, qp, kp, window=window)
    assert ops.KERNELS["flash_attention"].launches == n + 1
    if S > 1:
        full = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), window=window)
        want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), window=window)
        tol = 2e-2 if dt == torch.bfloat16 else 3e-5
        assert float((full.float() - want.float()).abs().max()) < tol


DTYPES = [torch.uint8, torch.float32, torch.bfloat16, torch.int8,
          torch.int32]


def _bytes(t):
    return t.reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("dt", DTYPES)
def test_gather_masked_read_keeps_out(dev, dt):
    """-1 entries leave the rows of an existing ``out`` as they were."""
    g = torch.Generator(device=dev).manual_seed(11)
    pages = torch.randn((1000, 8, 128), device=dev, generator=g).mul(9).to(dt)
    table = torch.randint(0, 1000, (4099,), device=dev, generator=g,
                          dtype=torch.int32)
    table[::3] = -1
    before = torch.randn((4099, 8, 128), device=dev, generator=g).mul(9).to(
        dt)
    out = before.clone()
    n = ops.KERNELS["villa_gather"].launches
    assert ops.villa_gather(pages, table, out=out) is out
    want = ref.villa_gather_ref(pages, table, before.clone())
    assert torch.equal(_bytes(out), _bytes(want))
    assert torch.equal(_bytes(out[::3]), _bytes(before[::3]))
    assert ops.KERNELS["villa_gather"].launches == n + 1


@pytest.mark.parametrize("dt", DTYPES)
def test_gather_never_reads_out_of_range_device_entries(dev, dt):
    """A device table is not range-checked on the host: entries outside
    [0, N) are skipped on the card and their rows of ``out`` kept."""
    g = torch.Generator(device=dev).manual_seed(12)
    pages = torch.randn((300, 4, 64), device=dev, generator=g).mul(9).to(dt)
    table = torch.randint(0, 300, (777,), device=dev, generator=g,
                          dtype=torch.int32)
    bad = torch.arange(777, device=dev) % 5 == 0
    table[bad] = torch.tensor([300, 2**31 - 1, -2, -2**31, 301],
                              dtype=torch.int32, device=dev).repeat(32)[
                                  :int(bad.sum())]
    out = torch.zeros((777, 4, 64), device=dev).to(dt)
    ops.villa_gather(pages, table, out=out)
    torch.cuda.synchronize()
    assert not _bytes(out[bad]).any()
    good = ~bad
    assert torch.equal(_bytes(out[good]),
                       _bytes(pages[table[good].long()]))


@pytest.mark.parametrize("dt", DTYPES)
def test_gather_table_longer_than_the_persistent_grid(dev, dt):
    """More batches of 32 entries than the persistent grid's warps take in
    one pass, 16-byte pages and 1 KiB pages."""
    g = torch.Generator(device=dev).manual_seed(13)
    for shape, n in (((5000, 16 // torch.empty(0, dtype=dt).element_size()),
                      200_003), ((2000, 8, 128), 70_001)):
        pages = torch.randn(shape, device=dev, generator=g).mul(9).to(dt)
        table = torch.randint(-1, shape[0], (n,), device=dev, generator=g,
                              dtype=torch.int32)
        out = torch.ones((n,) + shape[1:], device=dev).to(dt)
        got = ops.villa_gather(pages, table, out=out.clone())
        want = ref.villa_gather_ref(pages, table, out.clone())
        assert torch.equal(_bytes(got), _bytes(want))
        full = ops.villa_gather(pages, table.clamp(min=0))
        assert torch.equal(_bytes(full), _bytes(pages[table.clamp(
            min=0).long()]))


def _decode_case(dev, B, T, H, K, D, dt, window, ring, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, 1, H, D), device=dev, generator=g).to(dt)
    k = torch.randn((B, T, K, D), device=dev, generator=g).to(dt)
    v = torch.randn((B, T, K, D), device=dev, generator=g).to(dt)
    rng = np.random.default_rng(seed)
    kv_pos = np.full((B, T), 2**30, np.int32)
    q_pos = np.zeros((B, 1), np.int32)
    for b in range(1, B):            # row 0 has no valid key
        n = int(rng.integers(1, (3 if ring else 1) * T + 1))
        t = np.arange(max(0, n - T), n)
        kv_pos[b, t % T] = t
        q_pos[b, 0] = n - 1
    return (q, k, v, torch.from_numpy(q_pos).to(dev),
            torch.from_numpy(kv_pos).to(dev))


@pytest.mark.parametrize("B,T,H,K,D,window,ring,dt", [
    (4, 1024, 32, 16, 128, 1024, True, torch.float32),  # gemma3 ring
    (4, 2048, 32, 16, 128, 0, False, torch.float32),    # gemma3 global
    (4, 2048, 32, 16, 128, 1024, False, torch.float32),  # global, windowed
    (8, 1024, 32, 4, 64, 0, False, torch.float32),      # tinyllama
    (8, 256, 32, 4, 64, 0, False, torch.float32),       # the launcher's
    (2, 77, 64, 1, 64, 0, False, torch.float32),        # G = 64
    (3, 1000, 8, 2, 32, 0, False, torch.float32),
    (2, 300, 4, 4, 16, 0, False, torch.float32),        # G = 1, D = 16
    (2, 9, 8, 2, 32, 0, False, torch.float32),          # T < one split
    (3, 500, 12, 4, 64, 100, True, torch.float32),      # G = 3, ring
    (4, 1024, 32, 16, 128, 1024, True, torch.bfloat16),
    (8, 1024, 32, 4, 64, 0, False, torch.bfloat16),     # two head groups
    (2, 100, 6, 2, 16, 0, False, torch.bfloat16),       # G = 3, D = 16
    (2, 64, 64, 1, 32, 0, False, torch.bfloat16),       # G = 64 in bf16
    (1, 20000, 2, 1, 16, 0, False, torch.float32),      # 417 splits
])
def test_split_kv_decode_matches_plain(dev, B, T, H, K, D, window, ring, dt):
    """The split-KV kernel against the plain chunked attention and its
    plain twin, at the serving shapes and at the edges of its layout; a
    row with no valid key gives exactly 0, two runs give the same bits,
    and one call counts one launch."""
    q, k, v, qp, kp = _decode_case(dev, B, T, H, K, D, dt, window, ring,
                                   seed=B * T + H)
    from repro_torch.kernels import flash_attention as FA

    n = ops.KERNELS["flash_attention"].launches
    out = ops.chunked_attention(q, k, v, qp, kp, window=window)
    again = ops.chunked_attention(q, k, v, qp, kp, window=window)
    torch.cuda.synchronize()
    assert ops.KERNELS["flash_attention"].launches == n + 2
    assert torch.equal(_bytes(out), _bytes(again))
    assert not out[0].float().any()
    want = ref.chunked_attention_ref(q, k, v, qp, kp, window=window)
    _assert_within_bar(out, want, q, k, v, qp, kp, window=window)
    _, _, ns, sl = FA.decode_plan(B, K, H // K, T, k.element_size(),
                                  torch.cuda.get_device_properties(
                                      dev).multi_processor_count, D)
    twin = ref.split_decode_ref(q, k, v, qp, kp, n_split=ns, split_len=sl,
                                window=window)
    _assert_within_bar(out, twin, q, k, v, qp, kp, window=window)


def test_decode_of_k_v_off_16_byte_boundaries(dev):
    """K/V views that do not start on a 16-byte boundary: the wrapper
    copies them for the split-KV kernel's vector loads, and the result
    matches the plain version."""
    q, k, v, qp, kp = _decode_case(dev, 3, 200, 8, 2, 32, torch.float32, 0,
                                   False, seed=14)
    flat = torch.empty(2 * k.numel() + 2, device=dev)
    off_k = flat[1:k.numel() + 1].view(k.shape)
    off_v = flat[k.numel() + 2:].view(v.shape)
    off_k.copy_(k)
    off_v.copy_(v)
    assert off_k.data_ptr() % 16 and off_v.data_ptr() % 16
    out = ops.chunked_attention(q, off_k, off_v, qp, kp)
    want = ref.chunked_attention_ref(q, k, v, qp, kp)
    assert float((out - want).abs().max()) < 3e-5
    assert not out[0].any()


# ---- the decode kernel's cluster form ----------------------------------

def _cluster_case(dev, B, T, H, K, D, qdt, kvdt, window, ring, seed):
    """A decode case in q dtype ``qdt`` over K/V of ``kvdt`` (int8: the
    model's quantiser's codes and scales); row 0 has no valid key.
    Returns (q, k, v, q_pos, kv_pos, kwargs)."""
    from repro_torch.models.attention import quantise

    q, k, v, qp, kp = _decode_case(dev, B, T, H, K, D, torch.float32, window,
                                   ring, seed)
    if kvdt == torch.int8:
        (k, ks), (v, vs) = quantise(k), quantise(v)
        return q.to(qdt), k, v, qp, kp, dict(window=window, k_scale=ks,
                                             v_scale=vs)
    return q.to(qdt), k.to(kvdt), v.to(kvdt), qp, kp, dict(window=window)


def _hold_cluster(q, k, v, qp, kp, kw):
    """The decode call in the cluster form: one launch a call, counted as
    a cluster launch, the same bits twice, within ref.attention_bar of the
    plain version (3e-5 over an int8 cache, whose output is f32) and of
    the plain twin of its splits; a row with no valid key exactly 0.
    Returns its plan."""
    from repro_torch.kernels import flash_attention as FA

    plan = FA.decode_launch_plan(q, k)
    assert plan.form == "cluster" and 1 <= plan.cluster <= FA.CLUSTER_MAX
    fn = ops.KERNELS["flash_attention"]
    n = (fn.launches, fn.decode, fn.decode_cluster)
    out = ops.chunked_attention(q, k, v, qp, kp, **kw)
    again = ops.chunked_attention(q, k, v, qp, kp, **kw)
    torch.cuda.synchronize()
    assert (fn.launches, fn.decode, fn.decode_cluster) == (
        n[0] + 2, n[1] + 2, n[2] + 2)
    assert torch.equal(_bytes(out), _bytes(again))
    assert not out[0].float().any()
    assert bool(torch.isfinite(out.float()).all())
    want = ref.chunked_attention_ref(q, k, v, qp, kp, **kw)
    twin = ref.split_decode_ref(q, k, v, qp, kp, n_split=plan.n_split,
                                split_len=plan.split_len, **kw)
    window = kw.get("window", 0)
    for w in (want, twin):
        if k.dtype == torch.int8:
            assert float((out - w).abs().max()) < 3e-5
        else:
            _assert_within_bar(out, w, q, k, v, qp, kp, window=window)
    return plan


def _cluster_shapes():
    """Each instantiation of the cluster form as (q dtype, K/V dtype, head
    dim, head group, G): the group at the head group's size, and one
    below it where the group is then the same (G 1 and 3)."""
    from repro_torch.kernels import flash_attention as FA

    out = []
    for qd, kd, D, gc in sorted(FA.CLUSTER_DECODE, key=str):
        for G in sorted({gc, gc - 1 if gc > 2 else 1}):
            out.append((qd, kd, D, gc, G))
    return out


@pytest.mark.parametrize("qd,kd,D,gc,G", _cluster_shapes(), ids=str)
def test_cluster_decode_takes_each_instantiation(dev, qd, kd, D, gc, G):
    """Every (q dtype, K/V dtype, head dim, head group) of the cluster
    form, at T 300 (not a multiple of its splits), ragged rows, the
    later splits of short rows dead."""
    K, B, T = 2, 3, 300
    case = _cluster_case(dev, B, T, G * K, K, D, qd, kd, 0, False,
                         seed=D + 10 * G + 100 * gc)
    plan = _hold_cluster(*case)
    assert plan.head_group == gc and T % plan.split_len


@pytest.mark.parametrize("B,T,H,K,D,window,ring,qd,kd", [
    (8, 1024, 32, 4, 64, 0, False, torch.float32, torch.float32),  # tinyllama
    (8, 256, 32, 4, 64, 0, False, torch.float32, torch.float32),
    (4, 1024, 32, 4, 64, 0, False, torch.float32, torch.int8),     # K3d
    (4, 1024, 64, 8, 128, 0, False, torch.bfloat16, torch.float32),  # qwen
    (4, 1024, 32, 8, 128, 0, False, torch.bfloat16, torch.float32),  # jamba
    (4, 1024, 32, 8, 128, 1024, True, torch.float32, torch.int8),  # K3d G 4
    (4, 1024, 32, 8, 128, 1024, True, torch.bfloat16, torch.float32),
    (4, 2048, 32, 8, 128, 1024, False, torch.bfloat16, torch.float32),
    (8, 128, 16, 4, 128, 0, False, torch.bfloat16, torch.float32),  # 2 x 2
    (4, 4096, 32, 4, 64, 0, False, torch.float32, torch.float32),
    (2, 9, 32, 4, 64, 0, False, torch.float32, torch.float32),     # T < split
    (2, 9, 32, 8, 128, 0, False, torch.float32, torch.int8),
    (3, 500, 12, 4, 128, 100, True, torch.bfloat16, torch.float32),  # G 3
    (3, 8192, 8, 2, 128, 0, False, torch.bfloat16, torch.float32),  # 8 x 1024
])
def test_cluster_decode_matches_plain(dev, B, T, H, K, D, window, ring, qd,
                                      kd):
    """The cluster form at the serving shapes it takes (tinyllama, K3d,
    qwen1.5, jamba on one card and on 2 x 2), windows over wrapped rings,
    T shorter than one split and the longest splits it takes."""
    case = _cluster_case(dev, B, T, H, K, D, qd, kd, window, ring,
                         seed=B * T + H + D)
    _hold_cluster(*case)


@pytest.mark.parametrize("qd,kd,D", [(torch.float32, torch.float32, 64),
                                     (torch.float32, torch.int8, 64),
                                     (torch.bfloat16, torch.float32, 128)])
def test_cluster_decode_with_dead_splits_and_rows(dev, qd, kd, D):
    """Rows whose every split is dead (no valid key: exactly 0), rows
    whose only valid keys lie in the last split, and a window that leaves
    the first splits of a row dead."""
    B, T, H, K = 4, 1000, 32, 4
    case = list(_cluster_case(dev, B, T, H, K, D, qd, kd, 0, False, seed=7))
    kv = np.full((B, T), 2**30, np.int32)
    kv[1, T - 5:] = np.arange(5)             # only the last split
    kv[2] = np.arange(T)                     # every slot, window 100 below
    qpos = np.array([[0], [4], [T - 1], [0]], np.int32)
    case[3] = torch.from_numpy(qpos).to(dev)
    case[4] = torch.from_numpy(kv).to(dev)
    out = ops.chunked_attention(*case[:5], **case[5])
    assert not out[3].float().any()
    _hold_cluster(*case[:5], case[5])
    case[5]["window"] = 100
    _hold_cluster(*case[:5], case[5])


@pytest.mark.parametrize("qd,kd,D", [(torch.float32, torch.float32, 64),
                                     (torch.bfloat16, torch.float32, 128),
                                     (torch.float32, torch.int8, 64)])
def test_cluster_decode_of_q_off_16_byte_boundaries(dev, qd, kd, D):
    """q, K and V views that do not start on a 16-byte boundary: the
    wrapper copies them for the form's 16-byte copies, and the result
    matches the plain version."""
    q, k, v, qp, kp, kw = _cluster_case(dev, 3, 200, 16, 2, D, qd, kd, 0,
                                        False, seed=31)
    flat = torch.empty(q.numel() + 1, device=dev, dtype=qd)
    off_q = flat[1:].view(q.shape)
    off_q.copy_(q)
    assert off_q.data_ptr() % 16
    flat_k = torch.empty(k.numel() + 4, device=dev, dtype=kd)
    off_k = flat_k[4 // k.element_size() or 1:][:k.numel()].view(k.shape)
    off_k.copy_(k)
    assert off_k.data_ptr() % 16
    _hold_cluster(off_q, off_k, v, qp, kp, kw)


def test_cluster_decode_fits_shared_memory(dev):
    """Every instantiation of the cluster form, as the library reports
    its CTA's static and dynamic shared memory, fits an H100 CTA's 227
    KB, and its opt-in succeeds."""
    from repro_torch.kernels import flash_attention as FA

    lib = FA._decode_ready(torch.cuda.current_device())
    for qd, kd, D, gc in sorted(FA.CLUSTER_DECODE, key=str):
        smem = lib.flash_decode_cluster_smem(FA._DTYPES[qd],
                                             FA._KV_DTYPES[kd], D, gc)
        assert 0 < smem <= 227 * 1024, (qd, kd, D, gc, smem)
    assert lib.flash_decode_cluster_smem(0, 0, 64, 2) == -1


def test_attention_still_raises_outside_its_shapes(dev):
    """What K3 refuses on the card, each naming its ROADMAP Queue 2 row: a
    head dim above 512 or not a multiple of 8 (K3f), float16 (K3g), Dv !=
    Dk in decode (K3c), int8 K/V in prefill (K3d); also another (Dk, Dv)
    pair and mixed dtypes at Dk 192 / Dv 128."""
    pos = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    for d in (520, 100):
        q = torch.zeros((1, 4, 2, d), device=dev)
        with pytest.raises(ValueError, match=f"head_dim {d}.*K3f"):
            ops.chunked_attention(q, q, q, pos, pos, window=2)
    q = torch.zeros((1, 4, 2, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="K3g"):
        ops.chunked_attention(q, q, q, pos, pos)
    ki = torch.zeros((1, 4, 2, 64), device=dev, dtype=torch.int8)
    sc = torch.ones((1, 4, 2), device=dev)
    with pytest.raises(NotImplementedError, match="Queue 2 K3d"):
        ops.chunked_attention(q.float(), ki, ki, pos, pos, k_scale=sc,
                              v_scale=sc)
    q = torch.zeros((1, 4, 2, 64), device=dev)
    with pytest.raises(ValueError, match="head_dim 64 / 32"):
        ops.chunked_attention(q, q, q[..., :32].contiguous(), pos, pos)
    q = torch.zeros((1, 4, 2, 192), device=dev)
    v = torch.zeros((1, 4, 2, 128), device=dev)
    with pytest.raises(ValueError, match="one dtype"):
        ops.chunked_attention(q.bfloat16(), q, v, pos, pos)
    one = pos[:, :1]
    with pytest.raises(NotImplementedError, match="Queue 2 K3c"):
        ops.chunked_attention(q[:, :1], q, v, one, pos)


def test_gemma3_engine_on_card_matches_cpu(dev):
    """Reduced gemma3 (ring caches of 16 slots) through a suspend and a
    resume wave, on the card against the CPU."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, Request

    cfg = get_reduced("gemma3-27b")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 21, 40)]
    out = []
    for d in ("cpu", dev):
        e = Engine(cfg, params, slots=3, max_len=96, n_sessions=8, device=d)
        reqs = [Request(i, p, 12 + 4 * i) for i, p in enumerate(prompts)]
        for r in reqs:
            e.submit(r)
        while e.active:
            e.step()
        e.resume_many([0, 2], [20, 20])
        while e.active:
            e.step()
        out.append(([r.generated for r in reqs], dict(e.stats),
                    e.sessions.policy.tags.cpu().tolist(),
                    e.verify_failure_count(), int(e.verify_store())))
    assert out[0] == out[1]


def test_engine_on_card_matches_cpu(dev):
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, Request

    cfg = get_reduced("tinyllama-1.1b")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    engines = [Engine(cfg, params, slots=3, max_len=64, n_sessions=8,
                      device=d) for d in ("cpu", dev)]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 11, 17)]
    out = []
    for e in engines:
        reqs = [Request(i, p, 6 + i) for i, p in enumerate(prompts)]
        for r in reqs:
            e.submit(r)
        while e.active:
            e.step()
        e.resume_many([0, 2], [4, 5])
        e.resume(1, 3)
        while e.active:
            e.step()
        out.append(([r.generated for r in reqs], dict(e.stats),
                    e.sessions.policy.tags.cpu().tolist(),
                    e.verify_failure_count(), int(e.verify_store())))
    assert out[0] == out[1]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_moe_and_mla_engine_on_card_matches_cpu(dev, arch):
    """Reduced olmoe (MoE) and deepseek-v2 (MLA + MoE, at its full head
    dims, so that its prefill runs K3 at Dk 192 / Dv 128) through a suspend
    wave and a resume wave, on the card against the CPU: the MoE dispatch
    and combine, the absorbed MLA decode and K3 as the models call them."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, Request

    cfg = get_reduced(arch)
    if cfg.attn_kind == "mla":
        cfg = dataclasses.replace(cfg, qk_nope_dim=128, qk_rope_dim=64,
                                  v_head_dim=128)
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 40)]
    out = []
    for d in ("cpu", dev):
        e = Engine(cfg, params, slots=3, max_len=96, n_sessions=8, device=d)
        reqs = [Request(i, p, 10 + 3 * i) for i, p in enumerate(prompts)]
        ops.reset_launch_counts()
        for r in reqs:
            e.submit(r)
        for _ in range(4):
            e.step()
        e.suspend_many([0, 2])
        while e.active:
            e.step()
        e.resume_many([0, 2], [12, 12])
        while e.active:
            e.step()
        n = ops.launch_counts()
        out.append(([r.generated for r in reqs], dict(e.stats),
                    e.session_pos, e.session_tok,
                    e.sessions.policy.tags.cpu().tolist(),
                    e.verify_failure_count(), int(e.verify_store())))
    assert n["flash_attention_prefill"] > 0
    assert (n["flash_attention_decode"] > 0) == (cfg.attn_kind != "mla")
    assert out[0] == out[1]


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-7b"])
def test_recurrent_engine_on_card_matches_cpu(dev, arch):
    """Reduced jamba (mamba + attention + MoE) and rwkv6 through exact-
    length prefills, a suspend wave and a resume wave, on the card against
    the CPU: the scans' step loops, the state pages and (jamba) K3 as the
    model calls it; rwkv6 launches no K3."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, Request

    cfg = get_reduced(arch)
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (1, 19, 40)]
    out = []
    for d in ("cpu", dev):
        e = Engine(cfg, params, slots=3, max_len=96, n_sessions=8, device=d)
        reqs = [Request(i, p, 10 + 3 * i) for i, p in enumerate(prompts)]
        ops.reset_launch_counts()
        for r in reqs:
            e.submit(r)
        for _ in range(4):
            e.step()
        e.suspend_many([0, 2])
        while e.active:
            e.step()
        e.resume_many([0, 2], [12, 12])
        while e.active:
            e.step()
        n = ops.launch_counts()
        out.append(([r.generated for r in reqs], dict(e.stats),
                    e.session_pos, e.session_tok,
                    e.verify_failure_count(), int(e.verify_store())))
    attn = "attn_full" in cfg.layer_kinds()
    assert (n["flash_attention"] > 0) == attn
    assert n["villa_scatter"] > 0 and n["villa_gather"] > 0
    assert out[0] == out[1]


@pytest.mark.parametrize("shape,dt", [
    ((1000, 333), torch.float32), ((7, 129, 65), torch.bfloat16),
    ((4096,), torch.int32), ((256, 128), torch.int8), ((13,), torch.uint8),
    ((0,), torch.float32), ((3, 5, 7), torch.bool),
])
def test_rbm_copy_bit_exact(dev, shape, dt):
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(shape, device=dev, generator=g).mul(60).to(dt)
    n = ops.KERNELS["rbm_copy"].launches
    got = ops.rbm_copy(x, tile_rows=64)
    want = ref.rbm_copy_ref(x, tile_rows=64)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == x.dtype
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert torch.equal(got.view(torch.uint8), x.view(torch.uint8))
    assert ops.KERNELS["rbm_copy"].launches == n + (x.numel() > 0)


@pytest.mark.parametrize("offset", [1, 3, 8, 16])
def test_rbm_copy_of_a_misaligned_view(dev, offset):
    """A view with a storage offset: the source is not 16-byte aligned
    (or not at the destination's alignment), so the kernel's byte path
    copies it."""
    base = torch.randint(0, 256, (100_003,), dtype=torch.uint8, device=dev)
    x = base[offset:]
    got = ops.rbm_copy(x, tile_rows=3, lanes=128)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.rbm_copy_ref(x, tile_rows=3, lanes=128))
    assert got.data_ptr() % 16 == 0


def test_tile_copy_leg_on_card(dev):
    from repro_torch import movement as MV

    x = torch.randn((37, 129), device=dev)
    p = MV.plan(MV.Transfer(MV.Tier("device"), MV.Tier("device"),
                            MV.Layout.dense(x.shape, np.float32)))
    out = MV.execute(p, data=x)["data"]
    torch.cuda.synchronize()
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    with pytest.raises(ValueError, match="contiguous"):
        ops.rbm_copy(x.t())


def test_scheduler_on_card_matches_cpu(dev):
    """The scheduler reads fast-tier residency while the decode it issued
    is in flight: its decisions on the card equal those on the CPU."""
    import dataclasses

    from repro_torch import sched
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine

    cfg = get_reduced("tinyllama-1.1b")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    wl = sched.WorkloadConfig(n_fresh=8, n_followups=20, arrival="bursty",
                              burst=4, zipf_s=1.8, mean_gap_ns=1600.0)
    arrivals = sched.generate_workload(wl, seed=4, vocab_size=cfg.vocab_size)
    out = []
    for d in ("cpu", dev):
        eng = Engine(cfg, params, slots=4, max_len=96, device=d,
                     n_sessions=sched.n_sessions_for(wl))
        s = sched.Scheduler(eng, policy="cost_aware", arrivals=arrivals)
        summary = s.run()
        out.append(([dataclasses.astuple(x) for x in s.metrics.decisions],
                    summary, dict(eng.stats), eng.session_tok,
                    eng.verify_failure_count()))
    assert out[0] == out[1]


def _prefill_case(dev, B, S, T, H, K, D, dt, seed, empty_row=False):
    """Prefill inputs: batch row b holds a prompt of n_b <= min(S, T)
    tokens at positions 0..n_b-1 in its first slots; its other query rows
    and slots are padding at 2**30 (as the Engine's buckets); with
    ``empty_row`` row 0's keys are all padding and its queries at 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, S, H, D), device=dev, generator=g).to(dt)
    k = torch.randn((B, T, K, D), device=dev, generator=g).to(dt)
    v = torch.randn((B, T, K, D), device=dev, generator=g).to(dt)
    rng = np.random.default_rng(seed)
    q_pos = np.full((B, S), 2**30, np.int32)
    kv_pos = np.full((B, T), 2**30, np.int32)
    for b in range(B):
        n = min(S, T) if b == B - 1 else int(rng.integers(1, min(S, T) + 1))
        q_pos[b, :n] = np.arange(T - n, T)[:n] if T < S else np.arange(n)
        kv_pos[b, :n] = np.arange(n)
    if empty_row:
        q_pos[0] = 0
        kv_pos[0] = 2**30
    return (q, k, v, torch.from_numpy(q_pos).to(dev),
            torch.from_numpy(kv_pos).to(dev))


@pytest.mark.parametrize("B,S,T,H,K,D,window,dt", [
    (1, 1500, 1500, 32, 16, 128, 1024, torch.float32),  # gemma3 local
    (1, 1500, 1500, 32, 16, 128, 0, torch.float32),     # gemma3 global
    (1, 512, 512, 32, 4, 64, 0, torch.float32),         # tinyllama 512
    (1, 16, 16, 32, 4, 64, 0, torch.float32),           # tinyllama 16
    (2, 37, 37, 4, 4, 16, 0, torch.float32),            # G = 1, D = 16
    (2, 300, 300, 8, 4, 32, 100, torch.float32),        # G = 2, D = 32
    (3, 77, 130, 64, 1, 64, 1, torch.float32),          # G = 64, W = 1
    (2, 200, 65, 24, 3, 128, 0, torch.float32),         # T < S, G = 8
    (1, 1500, 1500, 32, 16, 128, 1024, torch.bfloat16),
    (2, 300, 300, 16, 2, 64, 100, torch.bfloat16),
    (2, 37, 37, 4, 4, 16, 0, torch.bfloat16),
    (3, 77, 130, 64, 1, 32, 1, torch.bfloat16),
])
def test_prefill_matches_plain(dev, B, S, T, H, K, D, window, dt):
    """The tensor-core prefill kernel against the plain chunked attention:
    S and T not multiples of the 64-key tile or of a CTA's queries, G 1-64,
    D 16-128, windows 1-1024, padded rows at 2**30, row 0 with no valid key
    (exactly 0), bf16; one call counts one prefill launch, and two calls
    give the same bits."""
    q, k, v, qp, kp = _prefill_case(dev, B, S, T, H, K, D, dt,
                                    seed=S * 7 + T + H + D, empty_row=B > 1)
    fn = ops.KERNELS["flash_attention"]
    n, n_pre, n_dec = fn.launches, fn.prefill, fn.decode
    out = ops.chunked_attention(q, k, v, qp, kp, window=window)
    again = ops.chunked_attention(q, k, v, qp, kp, window=window)
    torch.cuda.synchronize()
    assert (fn.launches, fn.prefill, fn.decode) == (n + 2, n_pre + 2, n_dec)
    assert torch.equal(_bytes(out), _bytes(again))
    want = ref.chunked_attention_ref(q, k, v, qp, kp, window=window)
    _assert_within_bar(out, want, q, k, v, qp, kp, window=window)
    if B > 1:
        assert not out[0].float().any()


def test_prefill_of_views_off_16_byte_boundaries(dev):
    """q/k/v views that do not start on a 16-byte boundary: the wrapper
    copies them for the prefill kernel's 16-byte loads."""
    q, k, v, qp, kp = _prefill_case(dev, 2, 70, 70, 8, 2, 32, torch.float32,
                                    seed=15)
    views = []
    for t in (q, k, v):
        flat = torch.empty(t.numel() + 1, device=dev)
        views.append(flat[1:].view(t.shape))
        views[-1].copy_(t)
        assert views[-1].data_ptr() % 16
    out = ops.chunked_attention(*views, qp, kp, window=30)
    want = ref.chunked_attention_ref(q, k, v, qp, kp, window=30)
    assert float((out - want).abs().max()) < 3e-5


def _copy_sizes(dev):
    from repro_torch.kernels import rbm_copy as RC

    _, grid = RC._copy_launcher(dev.index or 0)
    chunk = RC._lib("rbm_copy").rbm_copy_chunk()
    return [1, 15, 16, 17, chunk - 16, chunk, chunk + 16,
            (grid + 3) * chunk + 5]


@pytest.mark.parametrize("dt", DTYPES + [torch.bool, torch.float16])
def test_rbm_copy_bulk_sizes(dev, dt):
    """The bulk copy bit-exact at 1, 15, 16 and 17 bytes (head and tail
    only), at a stage's size and 16 bytes either side, and at more chunks
    than the persistent grid has CTAs, on every dtype; at an aligned start
    and 1-15 bytes into a 16-byte line (head, body and tail)."""
    item = torch.empty(0, dtype=dt).element_size()
    g = torch.Generator(device=dev).manual_seed(16)
    for nbytes in _copy_sizes(dev):
        n = max(1, nbytes // item)
        base = torch.randint(0, 256, (n * item + 16,), dtype=torch.uint8,
                             device=dev, generator=g)
        for skip in (0, item, 16 - item if item < 16 else 0):
            x = base[skip:skip + n * item].view(dt)
            got = ops.rbm_copy(x)
            torch.cuda.synchronize()
            assert torch.equal(_bytes(got), _bytes(x)), (nbytes, skip)


def test_rbm_copy_misaligned_pair_large(dev):
    """Source and destination that differ mod 16 over many chunks: the
    byte path over the whole grid."""
    base = torch.randint(0, 256, (3 * 32768 * 64 + 7,), dtype=torch.uint8,
                         device=dev)
    x = base[3:]
    got = ops.rbm_copy(x)
    torch.cuda.synchronize()
    assert got.data_ptr() % 16 == 0 and torch.equal(got, x)


# ---- head dim 256 and q over k/v of another dtype -------------------------

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("B,S,T,H,K,D,window,qdt,kvdt", [
    (2, 1, 1000, 16, 16, 256, 0, F32, F32),       # gemma-7b decode (MHA)
    (2, 1, 1000, 16, 16, 256, 0, BF16, BF16),
    (3, 1, 777, 8, 2, 256, 100, F32, F32),        # G = 4 at 256, a window
    (3, 1, 777, 8, 2, 256, 100, BF16, BF16),
    (2, 1, 300, 12, 4, 256, 0, BF16, F32),        # mixed at 256, G = 3
    (2, 1, 300, 12, 4, 256, 0, F32, BF16),
    (4, 1, 1024, 32, 16, 128, 1024, BF16, F32),   # gemma3's ring, bf16 q
    (4, 1, 2048, 32, 16, 128, 0, BF16, F32),      # gemma3's global
    (3, 1, 500, 24, 3, 64, 0, F32, BF16),         # G = 8 over a bf16 cache
    (3, 1, 500, 24, 3, 64, 0, BF16, F32),         # G = 8, head group 8
    (4, 1, 1024, 64, 8, 128, 0, BF16, F32),       # qwen1.5's: G = 8, D 128
    (2, 1, 100, 6, 2, 16, 0, BF16, F32),          # D = 16
    (2, 1, 9, 8, 2, 32, 0, F32, BF16),            # T < one split
    (2, 300, 300, 16, 16, 256, 0, F32, F32),      # gemma-7b prefill
    (2, 300, 300, 16, 16, 256, 0, BF16, BF16),
    (2, 130, 200, 8, 2, 256, 50, F32, F32),       # T > S, T % 64, a window
    (2, 130, 200, 8, 2, 256, 50, BF16, BF16),
    (3, 77, 77, 64, 1, 256, 0, F32, F32),         # G = 64 at 256: 1 query
    (2, 200, 200, 8, 2, 256, 0, BF16, F32),
    (2, 200, 200, 8, 2, 256, 0, F32, BF16),
    (1, 1500, 1500, 32, 16, 128, 1024, BF16, F32),  # gemma3's, bf16 q
    (2, 100, 100, 8, 4, 64, 30, F32, BF16),
    (2, 37, 37, 4, 4, 16, 0, BF16, F32),          # D = 16, G = 1
])
def test_wide_and_mixed_attention_match_plain(dev, B, S, T, H, K, D, window,
                                              qdt, kvdt):
    """Both kernels at head dim 256 and over q and k/v of different dtypes
    (the reference promotes inside the kernel region, and so do the
    kernels: nothing is cast before the launch), against the plain chunked
    attention: T not a multiple of the tiles or splits, windows, G 1-64,
    batch row 0 with no valid key (exactly 0), the output in q's dtype,
    one launch a call on its route, two calls giving the same bits."""
    if S == 1:
        q, k, v, qp, kp = _decode_case(dev, B, T, H, K, D, F32, window,
                                       window > 0, seed=B * T + H + D)
    else:
        q, k, v, qp, kp = _prefill_case(dev, B, S, T, H, K, D, F32,
                                        seed=S * 7 + T + H + D,
                                        empty_row=True)
    q, k, v = q.to(qdt), k.to(kvdt), v.to(kvdt)
    fn = ops.KERNELS["flash_attention"]
    n, n_pre, n_dec = fn.launches, fn.prefill, fn.decode
    out = ops.chunked_attention(q, k, v, qp, kp, window=window)
    again = ops.chunked_attention(q, k, v, qp, kp, window=window)
    torch.cuda.synchronize()
    step = (2, 0) if S > 1 else (0, 2)
    assert (fn.launches, fn.prefill, fn.decode) == (n + 2, n_pre + step[0],
                                                    n_dec + step[1])
    assert out.dtype == qdt and out.shape == q.shape
    assert torch.equal(_bytes(out), _bytes(again))
    assert not out[0].float().any()
    want = ref.chunked_attention_ref(q, k, v, qp, kp, window=window)
    _assert_within_bar(out, want, q, k, v, qp, kp, window=window)


PAIRS = [(F32, F32), (BF16, BF16), (BF16, F32), (F32, BF16)]


@pytest.mark.parametrize("qdt,kvdt", PAIRS)
@pytest.mark.parametrize("B,S,T,H,K,D,window", [
    (3, 1, 1024, 64, 1, 512, 128),   # DeepSeek-V4-Flash decode: width 512
    (2, 1, 777, 128, 1, 512, 0),     # DeepSeek-V4-Pro: 64 head groups
    (2, 1, 500, 32, 32, 224, 0),     # Zamba2 decode: 224 in width 256
    (2, 1, 300, 71, 1, 72, 40),      # width 96, G 71
    (2, 1, 200, 8, 2, 96, 0),        # 96 padded at its own width
    (2, 1, 130, 6, 2, 264, 0),       # 264 in width 512
    (2, 1, 90, 4, 1, 8, 0),          # 8 in width 64
    (1, 300, 300, 64, 1, 512, 128),  # Flash prefill: two head slices
    (1, 77, 200, 128, 1, 512, 0),    # Pro prefill: four head slices
    (2, 70, 90, 8, 2, 512, 0),       # width 512 unpadded: G 4 in a CTA
    (2, 130, 130, 32, 32, 224, 0),   # Zamba2 prefill
    (2, 100, 160, 71, 1, 72, 30),    # width 96, G 71: one query a CTA
    (2, 90, 90, 8, 2, 96, 0),        # 96 padded at its own width
    (1, 70, 100, 4, 2, 264, 16),
    (2, 50, 50, 8, 4, 40, 0),        # 40 in width 64
    (2, 33, 33, 4, 4, 8, 0),         # 8 in width 64
])
def test_every_head_dim_and_group_matches_plain(dev, B, S, T, H, K, D,
                                                window, qdt, kvdt):
    """Head dims past the old five and groups past a CTA's rows, on both
    routes and the four (q, K/V) dtype pairs, at the new tile widths (96,
    512) and padded into the old ones, against the plain chunked attention
    under ref.attention_bar: the cache read at its true head dim, batch row
    0 with no valid key exactly 0, the output in q's dtype, one launch a
    call on its route, two calls giving the same bits."""
    if S == 1:
        q, k, v, qp, kp = _decode_case(dev, B, T, H, K, D, F32, window,
                                       window > 0, seed=B * T + H + D)
    else:
        q, k, v, qp, kp = _prefill_case(dev, B, S, T, H, K, D, F32,
                                        seed=S * 7 + T + H + D,
                                        empty_row=True)
    q, k, v = q.to(qdt), k.to(kvdt), v.to(kvdt)
    fn = ops.KERNELS["flash_attention"]
    n, n_pre, n_dec = fn.launches, fn.prefill, fn.decode
    out = ops.chunked_attention(q, k, v, qp, kp, window=window)
    again = ops.chunked_attention(q, k, v, qp, kp, window=window)
    torch.cuda.synchronize()
    step = (2, 0) if S > 1 else (0, 2)
    assert (fn.launches, fn.prefill, fn.decode) == (n + 2, n_pre + step[0],
                                                    n_dec + step[1])
    assert out.dtype == qdt and out.shape == q.shape
    assert torch.equal(_bytes(out), _bytes(again))
    assert not out[0].float().any()
    want = ref.chunked_attention_ref(q, k, v, qp, kp, window=window)
    _assert_within_bar(out, want, q, k, v, qp, kp, window=window)


@pytest.mark.parametrize("qdt,kvdt", PAIRS)
@pytest.mark.parametrize("B,S,H,K,D,window", [
    (1, 130, 32, 32, 224, 0),     # Zamba2's heads
    (1, 100, 64, 1, 512, 64),     # width 512, two head slices, a window
    (2, 45, 128, 1, 512, 0),      # four head slices
    (2, 77, 71, 1, 72, 0),        # width 96
])
def test_train_attention_at_every_head_dim_and_group(dev, B, S, H, K, D,
                                                     window, qdt, kvdt):
    """K3e at the tile widths and groups: the forward is one launch of the
    prefill kernel within the bar of the plain twin; the backward kernel
    (widths to 256) gives dq/dk/dv within 2x the twin's own gap to the
    twin in f64, bit-equal call to call; width 512 keeps the counted
    recompute, equal to the twin's gradients (_hold_k3e)."""
    g = torch.Generator(device=dev).manual_seed(D + H)
    q = torch.randn((B, S, H, D), device=dev, generator=g).to(qdt)
    k = torch.randn((B, S, K, D), device=dev, generator=g).to(kvdt)
    v = torch.randn((B, S, K, D), device=dev, generator=g).to(kvdt)
    pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S)
    up = torch.randn((B, S, H, D), device=dev, generator=g).to(qdt)
    _hold_k3e(q, k, v, pos, pos, up, window=window)


@pytest.mark.parametrize("S", [1, 64])
@pytest.mark.parametrize("qdt,kvdt", [(F32, F32), (BF16, BF16)])
def test_kv_views_off_16_byte_boundaries_at_head_dim_224(dev, S, qdt, kvdt):
    """K/V views at head dim 224 (a row of 896 or 448 bytes) that do not
    start on a 16-byte boundary: the wrapper's one copy, then the kernel
    reads them at width 256; the result within the bar."""
    T = 100
    q, k, v, qp, kp = (_decode_case(dev, 2, T, 32, 32, 224, F32, 0, False,
                                    seed=23) if S == 1 else
                       _prefill_case(dev, 2, S, T, 32, 32, 224, F32,
                                     seed=23))
    q, k, v = q.to(qdt), k.to(kvdt), v.to(kvdt)
    flat = torch.empty(2 * k.numel() + 2, device=dev, dtype=kvdt)
    off_k = flat[1:k.numel() + 1].view(k.shape)
    off_v = flat[k.numel() + 2:].view(v.shape)
    off_k.copy_(k)
    off_v.copy_(v)
    assert off_k.data_ptr() % 16 and off_v.data_ptr() % 16
    out = ops.chunked_attention(q, off_k, off_v, qp, kp)
    want = ref.chunked_attention_ref(q, k, v, qp, kp)
    _assert_within_bar(out, want, q, k, v, qp, kp)


@pytest.mark.parametrize("S", [1, 90])
@pytest.mark.parametrize("qdt,kvdt", [(F32, F32), (BF16, F32)])
def test_wide_attention_of_a_q_off_16_byte_boundaries(dev, S, qdt, kvdt):
    """A q view that does not start on a 16-byte boundary, at head dim
    256: the wrapper copies it for the kernels' 16-byte loads."""
    T = 90
    q, k, v, qp, kp = (_decode_case(dev, 2, T, 8, 4, 256, F32, 0, False,
                                    seed=16) if S == 1 else
                       _prefill_case(dev, 2, S, T, 8, 4, 256, F32, seed=16))
    q, k, v = q.to(qdt), k.to(kvdt), v.to(kvdt)
    flat = torch.empty(q.numel() + 1, device=dev, dtype=qdt)
    off_q = flat[1:].view(q.shape)
    off_q.copy_(q)
    assert off_q.data_ptr() % 16
    out = ops.chunked_attention(off_q, k, v, qp, kp)
    want = ref.chunked_attention_ref(q, k, v, qp, kp)
    _assert_within_bar(out, want, q, k, v, qp, kp)


@pytest.mark.parametrize("S", [1, 8])
def test_mixed_k_and_v_raise(dev, S):
    """k and v of different dtypes are outside the contract (the
    reference's cache holds one dtype for both): the wrapper raises."""
    q = torch.zeros((1, S, 4, 64), device=dev)
    k = torch.zeros((1, 16, 2, 64), device=dev)
    pos = torch.zeros((1, S), dtype=torch.int32, device=dev)
    kv_pos = torch.zeros((1, 16), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="k/v share"):
        ops.chunked_attention(q, k, k.bfloat16(), pos, kv_pos)



@pytest.mark.parametrize("B,S,T,H,K,window,dt", [
    (1, 1024, 1024, 128, 128, 0, F32),    # deepseek-v2's bucket 1024
    (1, 1024, 1024, 128, 128, 0, BF16),
    (3, 200, 200, 16, 16, 0, F32),        # ragged ends, S % 64 != 0
    (3, 200, 200, 16, 16, 0, BF16),
    (2, 16, 16, 8, 8, 0, F32),            # the 16-row bucket
    (2, 16, 16, 8, 8, 0, BF16),
    (2, 90, 150, 8, 8, 0, F32),           # T > S, T % 64 != 0
    (2, 90, 150, 8, 8, 0, BF16),
    (2, 77, 77, 8, 2, 20, F32),           # G = 4 and a window
    (2, 77, 77, 8, 2, 20, BF16),
    (2, 40, 60, 130, 1, 0, F32),          # G 130: two head slices
    (2, 40, 60, 130, 1, 0, BF16),
])
def test_mla_prefill_matches_plain(dev, B, S, T, H, K, window, dt):
    """The prefill kernel at Dk 192 / Dv 128 (MLA's expanded K and V)
    against the plain chunked attention: ragged prompt ends padded at
    2**30, batch row 0 with no valid key (exactly 0), S and T off the
    tiles, a group past a CTA's 128 rows (the general instantiation's head
    slices), f32 and bf16; the output (B,S,H,128) in q's dtype, one prefill
    launch a call, two calls giving the same bits."""
    q, k, v, qp, kp = _prefill_case(dev, B, S, T, H, K, 192, dt,
                                    seed=S + T + H + 192, empty_row=B > 1)
    v = v[..., 64:].contiguous()
    fn = ops.KERNELS["flash_attention"]
    n, n_pre, n_dec = fn.launches, fn.prefill, fn.decode
    out = ops.chunked_attention(q, k, v, qp, kp, window=window)
    again = ops.chunked_attention(q, k, v, qp, kp, window=window)
    torch.cuda.synchronize()
    assert (fn.launches, fn.prefill, fn.decode) == (n + 2, n_pre + 2, n_dec)
    assert out.dtype == dt and out.shape == (B, S, H, 128)
    assert torch.equal(_bytes(out), _bytes(again))
    want = ref.chunked_attention_ref(q, k, v, qp, kp, window=window)
    _assert_within_bar(out, want, q, k, v, qp, kp, window=window)
    if B > 1:
        assert not out[0].float().any()


def _short_case(dev, B, S, T, H, K, dk, dv, qdt, n, seed, empty_row):
    """A prefill case of the f32 path: q in ``qdt`` over f32 K/V at
    ``dk``/``dv``; the last batch row holds ``n`` tokens, the others fewer,
    each padded at 2**30 (the Engine's buckets), its queries the last S
    slots; with ``empty_row`` batch row 0's first query sits at -1, where
    it sees no key."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, S, H, dk), device=dev, generator=g).to(qdt)
    k = torch.randn((B, T, K, dk), device=dev, generator=g)
    v = torch.randn((B, T, K, dv), device=dev, generator=g)
    kv_pos = np.full((B, T), 2**30, np.int32)
    for b in range(B):
        kv_pos[b, :max(1, n - 9 * (B - 1 - b))] = np.arange(
            max(1, n - 9 * (B - 1 - b)))
    q_pos = kv_pos[:, T - S:].copy()
    if empty_row:
        q_pos[0, 0] = -1
    return (q, k, v, torch.from_numpy(q_pos).to(dev),
            torch.from_numpy(kv_pos).to(dev))


def _hold_short(q, k, v, qp, kp, window=0):
    """One call of K3 in the short form: counted once as a prefill and a
    short-form launch, two calls bit-equal, within ``ref.attention_bar`` of
    the plain version.  Returns the output."""
    fn = ops.KERNELS["flash_attention"]
    plan = ops.FA.launch_plan(q, k, v)
    assert plan.form == "short" and plan.route == "mma"
    n, n_pre, n_short = fn.launches, fn.prefill, fn.prefill_short
    out = ops.chunked_attention(q, k, v, qp, kp, window=window)
    again = ops.chunked_attention(q, k, v, qp, kp, window=window)
    torch.cuda.synchronize()
    assert (fn.launches, fn.prefill, fn.prefill_short) == (
        n + 2, n_pre + 2, n_short + 2)
    assert torch.equal(_bytes(out), _bytes(again))
    assert out.dtype == q.dtype and out.shape == (*q.shape[:3], v.shape[-1])
    want = ref.chunked_attention_ref(q, k, v, qp, kp, window=window)
    _assert_within_bar(out, want, q, k, v, qp, kp, window=window)
    return out


@pytest.mark.parametrize("B,S,T,H,K,dk,dv,window,qdt,n", [
    (1, 64, 64, 16, 16, 256, 256, 0, F32, 40),     # gemma-7b's bucket 64
    (2, 64, 64, 128, 128, 192, 128, 0, F32, 40),   # deepseek-v2 MLA's
    (2, 16, 16, 32, 4, 64, 64, 0, F32, 16),        # G 8, D 64, S 16
    (1, 128, 128, 32, 16, 128, 128, 0, F32, 96),   # gemma3's bucket 128
    (1, 128, 128, 32, 16, 128, 128, 1024, F32, 96),  # its window
    (2, 128, 128, 32, 16, 128, 128, 40, F32, 128),   # a window that cuts
    (1, 64, 64, 16, 16, 128, 128, 0, F32, 40),     # olmoe's bucket 64
    (2, 64, 64, 16, 16, 256, 256, 20, F32, 64),    # a window
    (2, 200, 200, 8, 8, 256, 256, 0, F32, 200),    # T past one tile
    (2, 150, 150, 16, 16, 192, 128, 30, F32, 150),  # MLA past a tile
    (1, 300, 300, 8, 4, 64, 64, 100, F32, 300),    # two stages, window
    (2, 16, 64, 16, 16, 64, 64, 0, F32, 64),       # S < T: 16 over 64
])
def test_short_form_prefill_matches_plain(dev, B, S, T, H, K, dk, dv,
                                          window, qdt, n):
    """The short form of the f32 prefill (``prefill_short_kernel``): at
    gemma-7b's and MLA's f32 bucket 64, tinyllama's G 8 bucket 16, gemma3's
    bucket 128 (96 tokens, global and under its window 1024) and olmoe's
    bucket 64 at D 128, windows, T past one tile (the live-tile scan and the
    ring, one stage above D 128) and fewer queries than keys; ragged rows
    at 2**30 and, in batch row 0, a query with no valid key (exactly 0);
    one launch a call, two calls bit-equal, within the bar of the plain
    version."""
    q, k, v, qp, kp = _short_case(dev, B, S, T, H, K, dk, dv, qdt, n,
                                  seed=S + T + H + dk + window,
                                  empty_row=B > 1)
    out = _hold_short(q, k, v, qp, kp, window)
    if B > 1:
        assert not out[0, 0].float().any()


@pytest.mark.parametrize("B,S,H,K,D,n", [
    (2, 32, 64, 8, 128, 24),      # qwen1.5's heads at D 128
    (2, 16, 8, 1, 64, 13),        # D 64
    (2, 64, 4, 4, 256, 50),       # D 256
])
def test_bf16_q_over_f32_kv_keeps_the_full_form(dev, B, S, H, K, D, n):
    """bf16 q over f32 K/V at short buckets, which no path prefills (a
    layer's prefill attends over its own K/V, in the weights' dtype): the
    full form, as before the short form, one launch a call and no
    short-form launch, two calls bit-equal, within ``ref.attention_bar``
    of the plain version; a query with no valid key gives 0."""
    q, k, v, qp, kp = _short_case(dev, B, S, S, H, K, D, D, BF16, n,
                                  seed=S + H + D, empty_row=True)
    assert ops.FA.launch_plan(q, k, v) == ops.FA.prefill_plan(
        B, S, H, K, D, True, D)
    fn = ops.KERNELS["flash_attention"]
    n0, n_short = fn.launches, fn.prefill_short
    out = ops.chunked_attention(q, k, v, qp, kp)
    again = ops.chunked_attention(q, k, v, qp, kp)
    torch.cuda.synchronize()
    assert (fn.launches, fn.prefill_short) == (n0 + 2, n_short)
    assert torch.equal(_bytes(out), _bytes(again))
    assert out.dtype == BF16
    want = ref.chunked_attention_ref(q, k, v, qp, kp)
    _assert_within_bar(out, want, q, k, v, qp, kp)
    assert not out[0, 0].float().any()


def test_short_form_of_views_off_16_byte_boundaries(dev):
    """q/k/v views that do not start on a 16-byte boundary at gemma-7b's
    bucket 64: the wrapper copies them, and the short form runs on the
    copies."""
    q, k, v, qp, kp = _short_case(dev, 1, 64, 64, 16, 16, 256, 256, F32, 40,
                                  seed=31, empty_row=False)
    views = []
    for t in (q, k, v):
        flat = torch.empty(t.numel() + 1, device=dev)
        views.append(flat[1:].view(t.shape))
        views[-1].copy_(t)
        assert views[-1].data_ptr() % 16
    out = _hold_short(*views, qp, kp)
    assert torch.equal(out, ops.chunked_attention(q, k, v, qp, kp))


# ---- K3d: int8 K/V with per-token, per-head scales, decode route ---------

def _int8_case(dev, B, T, H, K, D, window, ring, seed, zero_scale=False):
    """A decode case over an int8 cache: the values quantised from random
    K/V by the model's quantiser, so codes and scales are the serving
    path's; ``zero_scale`` zeroes one valid key's and value's scales."""
    from repro_torch.models.attention import quantise

    q, k, v, qp, kp = _decode_case(dev, B, T, H, K, D, torch.float32,
                                   window, ring, seed)
    (k8, ks), (v8, vs) = quantise(k), quantise(v)
    if zero_scale:
        b = B - 1
        t = int((kp[b] < 2**30).nonzero()[0])
        ks[b, t], vs[b, t] = 0.0, 0.0
    return q, k8, v8, ks, vs, qp, kp


@pytest.mark.parametrize("B,T,H,K,D,window,ring,zero", [
    (4, 1024, 32, 4, 64, 0, False, False),     # tinyllama (D 64, G 8)
    (4, 1024, 32, 16, 128, 1024, True, False),  # gemma3's ring, wrapped
    (4, 2048, 32, 16, 128, 0, False, False),   # gemma3's global layer
    (4, 1024, 32, 8, 128, 0, False, False),    # jamba's attention (G 4)
    (3, 1000, 32, 4, 64, 0, False, True),      # T % 16 != 0, a zero scale
    (2, 9, 32, 16, 128, 0, False, False),      # T < one split
    (3, 333, 32, 8, 128, 50, False, True),     # a window, ragged T
    (2, 500, 32, 16, 128, 100, True, False),   # a ring past its window
])
def test_int8_decode_matches_plain(dev, B, T, H, K, D, window, ring, zero):
    """The split-KV kernel over int8 K/V against the plain chunked
    attention and the split twin with the same scales, within 3e-5; a
    row with no valid key (its slots at 2**30) gives exactly 0, two runs
    give the same bits, and a call counts one decode launch and one int8
    decode launch."""
    from repro_torch.kernels import flash_attention as FA

    q, k8, v8, ks, vs, qp, kp = _int8_case(dev, B, T, H, K, D, window, ring,
                                           seed=B * T + H + D, zero_scale=zero)
    fn = ops.KERNELS["flash_attention"]
    n = (fn.launches, fn.decode, fn.decode_int8, fn.prefill)
    out = ops.chunked_attention(q, k8, v8, qp, kp, window=window,
                                k_scale=ks, v_scale=vs)
    again = ops.chunked_attention(q, k8, v8, qp, kp, window=window,
                                  k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert (fn.launches, fn.decode, fn.decode_int8, fn.prefill) == (
        n[0] + 2, n[1] + 2, n[2] + 2, n[3])
    assert torch.equal(_bytes(out), _bytes(again))
    assert not out[0].any()
    want = ref.chunked_attention_ref(q, k8, v8, qp, kp, window=window,
                                     k_scale=ks, v_scale=vs)
    assert float((out - want).abs().max()) < 3e-5
    _, _, ns, sl = FA.decode_plan(B, K, H // K, T, 1, torch.cuda.
                                  get_device_properties(dev).
                                  multi_processor_count, D)
    twin = ref.split_decode_ref(q, k8, v8, qp, kp, n_split=ns, split_len=sl,
                                window=window, k_scale=ks, v_scale=vs)
    assert float((out - twin).abs().max()) < 3e-5


@pytest.mark.parametrize("D,G", [(64, 8), (128, 2), (128, 4)])
def test_int8_decode_takes_each_instantiation(dev, D, G):
    """Every instantiated (head dim, head group): K/V views off 16-byte
    boundaries (copied by the wrapper) and positions that are not slot
    order give the plain version's result."""
    from repro_torch.kernels import flash_attention as FA

    K, B, T = 2, 2, 130
    q, k8, v8, ks, vs, qp, kp = _int8_case(dev, B, T, G * K, K, D, 0, True,
                                           seed=D + G)
    assert (torch.float32, D, FA.decode_plan(B, K, G, T, 1, 132, D)[0]) in \
        FA.INT8_DECODE
    flat = torch.zeros(k8.numel() + 3, dtype=torch.int8, device=dev)
    off = flat[3:].view(k8.shape)
    off.copy_(k8)
    assert off.data_ptr() % 16
    out = ops.chunked_attention(q, off, v8, qp, kp, k_scale=ks, v_scale=vs)
    want = ref.chunked_attention_ref(q, k8, v8, qp, kp, k_scale=ks,
                                     v_scale=vs)
    assert float((out - want).abs().max()) < 3e-5


def test_int8_attention_raises_outside_its_instantiations(dev):
    q = torch.zeros((1, 1, 8, 64), device=dev)
    k8 = torch.zeros((1, 16, 2, 64), dtype=torch.int8, device=dev)
    s = torch.ones((1, 16, 2), device=dev)
    one = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    pos = torch.zeros((1, 16), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="Queue 2 K3d"):     # G 4 at D 64
        ops.chunked_attention(q, k8, k8, one, pos, k_scale=s, v_scale=s)
    with pytest.raises(ValueError, match="Queue 2 K3d"):     # bf16 q
        ops.chunked_attention(q[:, :, :4].bfloat16(), k8[:, :, :1],
                              k8[:, :, :1], one, pos, k_scale=s[..., :1],
                              v_scale=s[..., :1])
    q8 = torch.zeros((1, 16, 16, 64), device=dev)
    with pytest.raises(NotImplementedError, match="K3d"):    # prefill
        ops.chunked_attention(q8, k8, k8, pos, pos, k_scale=s, v_scale=s)
    with pytest.raises(ValueError, match="k_scale"):         # no scales
        ops.chunked_attention(q[:, :, :4], k8[:, :, :1], k8[:, :, :1], one,
                              pos)


def test_int8_decode_step_on_card_matches_cpu(dev):
    """A reduced tinyllama at head dim 64 and G 8 (an instantiated
    triple), 20 decode_step calls over an int8 cache on the card and on
    the CPU: int8 codes equal but where the two devices' f32 roundings
    straddle a half step, scales and logits within 1e-4, and 20 x layers
    int8 decode launches."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.serve.engine import _tree_to

    cfg = dataclasses.replace(get_reduced("tinyllama-1.1b"), n_heads=8,
                              n_kv_heads=1, head_dim=64)
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32))
    out = {}
    fn = ops.KERNELS["flash_attention"]
    n = fn.decode_int8
    for d in ("cpu", dev):
        p = _tree_to(params, d)
        cache = lm.init_cache(cfg, 2, 24, dtype=torch.int8, device=d)
        logits = [lm.decode_step(cfg, p, cache, toks[:, t:t + 1].to(d),
                                 t)[0].cpu() for t in range(20)]
        out[str(d)] = (torch.cat(logits, 1), {k: t.cpu() for k, t in
                                              cache["stage0"]["b0"].items()})
    assert fn.decode_int8 - n == 20 * cfg.n_layers
    (lc, cc), (lg, cg) = out["cpu"], out[str(dev)]
    assert float((lc - lg).abs().max()) < 1e-4
    diff = (cc["k"].int() - cg["k"].int()).abs()
    assert int(diff.max()) <= 1 and int(diff.sum()) <= diff.numel() // 1000
    assert torch.equal(cc["pos"], cg["pos"])
    assert torch.allclose(cc["k_scale"], cg["k_scale"], rtol=1e-5, atol=0)


# ---- the enc-dec and M-RoPE paths (K3 on their new uses) -------------------

def _positions_case(dev, B, S, T, H, K, D, dt, q_pos, kv_pos, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, S, H, D), device=dev, generator=g).to(dt)
    k = torch.randn((B, T, K, D), device=dev, generator=g).to(dt)
    v = torch.randn((B, T, K, D), device=dev, generator=g).to(dt)
    return (q, k, v, torch.from_numpy(np.ascontiguousarray(q_pos)).to(dev),
            torch.from_numpy(np.ascontiguousarray(kv_pos)).to(dev))


@pytest.mark.parametrize("B,T,H,D,pads,dt", [
    (2, 77, 16, 64, 0, torch.float32),      # odd T, one partial tile
    (1, 130, 4, 16, 0, torch.float32),      # past two 64-key tiles
    (2, 201, 16, 64, 23, torch.float32),    # 2**30 slots: visible too
    (1, 97, 8, 128, 0, torch.bfloat16),
])
def test_noncausal_prefill_matches_plain(dev, B, T, H, D, pads, dt):
    """The encoder's bidirectional attention (causal=False): every key is
    live for every row, 2**30 slots included (the reference masks nothing
    without causality), at T off the kernel's 64-key tiles."""
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    if pads:
        pos[:, -pads:] = 2**30
    q, k, v, qp, kp = _positions_case(dev, B, T, T, H, H, D, dt, pos, pos,
                                      21)
    out = ops.chunked_attention(q, k, v, qp, kp, causal=False)
    want = ref.chunked_attention_ref(q, k, v, qp, kp, causal=False)
    _assert_within_bar(out, want, q, k, v, qp, kp, causal=False)


@pytest.mark.parametrize("B,S,T,H,D,dt", [
    (3, 16, 300, 16, 64, torch.float32),    # cross prefill, odd T
    (4, 1, 4096, 16, 64, torch.float32),    # cross decode, seamless's T
    (3, 1, 301, 4, 16, torch.float32),
    (2, 7, 129, 8, 128, torch.bfloat16),
])
def test_cross_attention_positions_match_plain(dev, B, S, T, H, D, dt):
    """Cross attention's positions: every query at 2**29, frames at 0 or
    2**30 by the encoder mask.  Row 0 has every frame valid, row 1 ragged
    pads (its last 96 frames at 2**30, and every fifth), row 2 (where
    there is one) no valid frame at all, so its output is 0 and, in
    decode, every split of it is empty; no NaN anywhere."""
    kv = np.zeros((B, T), np.int32)
    kv[1, -96:] = 2**30
    kv[1, ::5] = 2**30
    if B > 2:
        kv[2] = 2**30
    qpos = np.full((B, S), 2**29, np.int32)
    q, k, v, qp, kp = _positions_case(dev, B, S, T, H, H, D, dt, qpos, kv,
                                      22)
    out = ops.chunked_attention(q, k, v, qp, kp)
    want = ref.chunked_attention_ref(q, k, v, qp, kp)
    assert bool(torch.isfinite(out).all())
    _assert_within_bar(out, want, q, k, v, qp, kp)
    if B > 2:
        assert not out[2].any()


@pytest.mark.parametrize("T", [1, 17, 512, 1000])
def test_decode_of_one_head_a_group_matches_plain(dev, T):
    """G 1 at D 64 (seamless's MHA self-attention): decode_plan rounds the
    group up to 2, so half of each CTA's heads are empty; every head's
    output is its own (an empty head writing would clobber its
    neighbour's) and finite."""
    from repro_torch.kernels import flash_attention as FA

    B, H, D = 4, 16, 64
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert FA.decode_plan(B, H, 1, T, 4, n_sm, D)[0] == 2
    kv = np.full((B, T), 2**30, np.int32)
    ends = [T, max(1, T // 2), 1, max(1, T - 3)]
    for b, n in enumerate(ends):
        kv[b, :n] = np.arange(n)
    qpos = np.array(ends, np.int32)[:, None] - 1
    q, k, v, qp, kp = _positions_case(dev, B, 1, T, H, H, D, torch.float32,
                                      qpos, kv, 23)
    out = ops.chunked_attention(q, k, v, qp, kp)
    want = ref.chunked_attention_ref(q, k, v, qp, kp)
    assert bool(torch.isfinite(out).all())
    _assert_within_bar(out, want, q, k, v, qp, kp)


@pytest.mark.parametrize("S,lo,hi,G,D,dt", [
    (200, 40, 140, 8, 128, torch.float32),     # repeats across tiles 0-2
    (200, 40, 140, 8, 128, torch.bfloat16),
    (130, 60, 70, 2, 16, torch.float32),       # straddles key 64
    (500, 20, 276, 8, 128, torch.bfloat16),    # phase 2's 16x16 image
])
def test_repeated_positions_prefill_matches_plain(dev, S, lo, hi, G, D, dt):
    """M-RoPE's causal positions are temporal ids, repeated over an image:
    rows lo..hi-1 share one position, so each sees all the others, within
    a 64-key tile and across tile boundaries; the text after resumes past
    it."""
    pos = np.arange(S, dtype=np.int32)
    pos[lo:hi] = lo
    pos[hi:] = lo + 1 + np.arange(S - hi)
    pos = pos[None]
    q, k, v, qp, kp = _positions_case(dev, 1, S, S, 2 * G, 2, D, dt, pos,
                                      pos, 24)
    out = ops.chunked_attention(q, k, v, qp, kp)
    want = ref.chunked_attention_ref(q, k, v, qp, kp)
    _assert_within_bar(out, want, q, k, v, qp, kp)


def test_seamless_prefill_and_decode_on_card_match_cpu(dev):
    """Reduced seamless at head dim 64 (the full model's: G 1, so decode
    runs the head group of 2): prefill with frame embeddings and 20
    decode_steps on the card against the CPU, logits within 1e-4, and K3's
    launches (layers x (encoder + self + cross) a prefill, layers x 2 a
    step).  64 frames, two of the reduced config's 32-key blocks, as the
    full model's 4096 are eight of its 512: at another count the CPU twin's
    encoder also attends the zero keys that pad its last block
    (``test_encoder_on_card_masks_block_pads_as_pallas``)."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.serve.engine import _tree_to

    cfg = dataclasses.replace(get_reduced("seamless-m4t-medium"),
                              head_dim=64)
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 26)
                                         ).astype(np.int32))
    frames = torch.from_numpy((rng.standard_normal((3, 64, cfg.d_model))
                               * 0.02).astype(np.float32))
    out = {}
    for d in ("cpu", dev):
        p = _tree_to(params, d)
        cache = lm.init_cache(cfg, 3, 32, device=d, enc_len=64)
        ops.reset_launch_counts()
        lg, _ = lm.prefill(cfg, p, toks[:, :6].to(d), cache,
                           enc_embeds=frames.to(d))
        logits = [lg.cpu()]
        for t in range(6, 26):
            logits.append(lm.decode_step(cfg, p, cache, toks[:, t:t + 1].to(d),
                                         t)[0].cpu())
        out[str(d)] = torch.cat(logits, 1)
    n = ops.launch_counts()
    assert n["flash_attention_prefill"] == 3 * cfg.n_layers
    assert n["flash_attention_decode"] == 2 * cfg.n_layers * 20
    assert float((out["cpu"] - out[str(dev)]).abs().max()) < 1e-4


def test_encoder_on_card_masks_block_pads_as_pallas(dev):
    """The encoder's attention (causal=False) over 70 frames, which the
    reduced config's 32-key blocks do not divide: the reference's jnp
    twin, and so the port's CPU path, pads the last block with zero keys
    that a non-causal row attends; the reference's Pallas kernel masks
    them (its ``kv padding``, flash_attention.py:63), and so does K3.  The
    card's encoder equals the CPU's where one block holds every frame,
    and differs from it at 32-key blocks."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.serve.engine import _tree_to

    cfg = dataclasses.replace(get_reduced("seamless-m4t-medium"),
                              head_dim=64)
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    frames = torch.from_numpy((np.random.default_rng(11).standard_normal(
        (3, 70, cfg.d_model)) * 0.02).astype(np.float32))
    card = lm._encode(cfg, _tree_to(params, dev), frames.to(dev)).cpu()
    one_block = lm._encode(dataclasses.replace(cfg, attn_block=128), params,
                           frames)
    padded = lm._encode(cfg, params, frames)
    assert float((card - one_block).abs().max()) < 1e-4
    assert float((card - padded).abs().max()) > 1e-3


def test_qwen2vl_engine_and_image_prefill_on_card_match_cpu(dev):
    """Reduced qwen2-vl at its full attention shape (8 q / 1 kv heads of
    128: G 8) through exact-length prefills, a suspend and a resume wave,
    on the card against the CPU; then lm.prefill of an image prompt (a
    temporal id repeated over 8 x 9 patches) on both, logits within 1e-4
    and the cache's positions the temporal ids."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, Request, _tree_to

    cfg = dataclasses.replace(get_reduced("qwen2-vl-72b"), n_heads=8,
                              n_kv_heads=1, head_dim=128)
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 70)]
    out = []
    for d in ("cpu", dev):
        e = Engine(cfg, params, slots=3, max_len=128, n_sessions=8, device=d)
        reqs = [Request(i, p, 10 + 3 * i) for i, p in enumerate(prompts)]
        for r in reqs:
            e.submit(r)
        for _ in range(4):
            e.step()
        e.suspend_many([0, 2])
        while e.active:
            e.step()
        e.resume_many([0, 2], [12, 12])
        while e.active:
            e.step()
        out.append(([r.generated for r in reqs], dict(e.stats),
                    e.session_pos, e.session_tok,
                    e.verify_failure_count(), int(e.verify_store())))
    assert out[0] == out[1]
    i, j = np.divmod(np.arange(72), 9)
    pos = np.concatenate([np.tile(np.arange(6), (3, 1)),
                          np.stack([np.full(72, 6), 6 + i, 6 + j]),
                          np.tile(np.arange(15, 25), (3, 1))], 1)
    pos = torch.from_numpy(pos.astype(np.int32))[:, None]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 88)
                                         ).astype(np.int32))
    got = {}
    for d in ("cpu", dev):
        cache = lm.init_cache(cfg, 1, 128, device=d)
        lg, _ = lm.prefill(cfg, _tree_to(params, d), toks.to(d), cache,
                           positions=pos.to(d))
        assert torch.equal(cache["stage0"]["b0"]["pos"][:, 0, :88].cpu(),
                           pos[0].expand(cfg.n_layers, 88))
        got[str(d)] = lg.cpu()
    assert float((got["cpu"] - got[str(dev)]).abs().max()) < 1e-4


@pytest.mark.parametrize("k", [1, 3])
def test_migration_route_from_one_pool_into_another(dev, k):
    """The migration route on the card: K2 gathers k sessions' pages out of
    one pool (the last page of the pool among them) and K1 scatters them
    into ANOTHER pool, one entry of its table -1 (skipped), bit-exact
    against the plain versions; through the fault-
    wrapped plan a flip_byte lands in one byte of the destination and the
    source pool keeps every byte."""
    from repro_torch import movement as MV
    from repro_torch.core.lisa.topology import MeshTopology
    from repro_torch.faults import inject as FI

    g = torch.Generator(device=dev).manual_seed(20 + k)
    spp = 5                                      # pages a session
    src = torch.randint(0, 256, (7 * spp, 8, 128), dtype=torch.uint8,
                        device=dev, generator=g)
    dst = torch.randint(0, 256, (4 * spp, 8, 128), dtype=torch.uint8,
                        device=dev, generator=g)
    rows_src, rows_dst = [6, 0, 3][:k], [3, 1, 0][:k]
    st = torch.cat([r * spp + torch.arange(spp, dtype=torch.int32)
                    for r in rows_src])
    dt = torch.cat([r * spp + torch.arange(spp, dtype=torch.int32)
                    for r in rows_dst])
    assert int(st.max()) == src.shape[0] - 1    # the pool's last page
    dt[1] = -1                                   # a skipped landing
    got = ops.villa_scatter(dst.clone(), dt, ops.villa_gather(src, st))
    want = ref.villa_scatter_ref(dst.cpu(), dt, ref.villa_gather_ref(
        src.cpu(), st))
    assert torch.equal(got.cpu(), want)
    src_before = src.clone()
    plan = MV.plan(MV.Transfer(MV.Tier("slow", index=0, axis="replica"),
                               MV.Tier("slow", index=2, axis="replica"),
                               MV.Layout.raw_pages(k * spp, 8, 128,
                                                   np.uint8)),
                   topo=MeshTopology(4))
    FI.install_fault_backends()
    try:
        landed = dst.clone()
        fault = np.asarray([FI.FAULT_CODES["flip_byte"], 4096 * k - 1,
                            0x81], np.int32)
        MV.execute(plan, src_pool=src, src_table=st, dst_pool=landed,
                   dst_table=dt, local_fabric=True, fault=fault)
    finally:
        FI.uninstall_fault_backends()
    torch.cuda.synchronize()
    assert torch.equal(src, src_before)
    assert int((landed.cpu() != want).sum()) == 1


def test_cluster_on_card_matches_cpu(dev):
    """The reduced tinyllama fleet on the card against the fleet on the
    CPU: a migration wave of two routes, a cross-replica fork, resumes on
    the destinations, tokens, stats and residence equal; one K2 and one
    K1 per route on the card."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.serve.cluster import Cluster
    from repro_torch.serve.engine import Request

    cfg = get_reduced("tinyllama-1.1b")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 11, 17, 9)]
    out = []
    for d in ("cpu", dev):
        cl = Cluster(cfg, params, n_replicas=4, slots=2, max_len=64,
                     n_sessions=8, device=d)
        reqs = [Request(i, p, 4) for i, p in enumerate(prompts)]
        for r in reqs:
            cl.submit(r, replica=r.uid // 2)
        while cl.active:
            cl.step()
        ops.reset_launch_counts()
        cl.migrate_many([(0, 2), (1, 2), (2, 3)])
        cl.fork(3, 9, replica=0, seed_token=5)
        counts = ops.launch_counts()
        slots = cl.resume_many([0, 1, 2, 9], 5)
        resumed = [cl.active[s] for s in slots]
        while cl.active:
            cl.step()
        out.append(([r.generated for r in reqs + resumed], cl.stats,
                    cl.residence, cl.verify_failure_count(), cl.scrub()))
        if d != "cpu":
            assert counts["villa_gather"] == counts["villa_scatter"] == 3
    assert out[0] == out[1]


@pytest.mark.parametrize("B,S,H,K,D,window", [
    (2, 77, 8, 8, 64, 0),        # odd S, G 1
    (1, 130, 32, 4, 64, 0),      # G 8 (tinyllama's heads), S off the tiles
    (2, 100, 16, 2, 128, 24),    # G 8 with a window
    (3, 33, 4, 4, 32, 5),        # G 1 with a window
])
def test_train_attention_grads_match_plain(dev, B, S, H, K, D, window):
    """K3e: under grad the forward is K3's prefill kernel (one prefill
    launch, the output within the bar of the plain twin, no decode) and
    the backward one call of the backward kernel, whose dq/dk/dv come
    within 2x the plain twin's own relative L2 gap to the twin in f64, and
    bit-equal from call to call (_hold_k3e)."""
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((B, S, H, D), device=dev, generator=g)
    k = torch.randn((B, S, K, D), device=dev, generator=g)
    v = torch.randn((B, S, K, D), device=dev, generator=g)
    pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S)
    up = torch.randn((B, S, H, D), device=dev, generator=g)
    _hold_k3e(q, k, v, pos, pos, up, window=window)


@pytest.mark.parametrize("case", ["no_key_rows", "non_causal_600",
                                  "s_ne_t", "s_ne_t_non_causal",
                                  "dout_off_16_bytes"])
def test_train_attention_backward_cases(dev, case):
    """K3e's backward kernel on what the training paths do not reach:
    query rows with no valid key (a batch row whose keys are all 2**30
    pads, a query before every key: zero gradients there, all finite),
    non-causal attention over T = 600 keys (the exact function: the twin
    runs over one block of all keys), S != T with the queries at the tail,
    and an upstream gradient that starts 4 bytes off a 16-byte boundary
    (copied before the launch)."""
    g = torch.Generator(device=dev).manual_seed(29)
    B, S, T, H, K, D, causal = {
        "no_key_rows": (3, 40, 40, 8, 2, 64, True),
        "non_causal_600": (2, 600, 600, 4, 1, 64, False),
        "s_ne_t": (2, 40, 100, 8, 2, 64, True),
        "s_ne_t_non_causal": (2, 40, 100, 8, 2, 128, False),
        "dout_off_16_bytes": (2, 70, 70, 16, 2, 64, True)}[case]
    q = torch.randn((B, S, H, D), device=dev, generator=g)
    k = torch.randn((B, T, K, D), device=dev, generator=g)
    v = torch.randn((B, T, K, D), device=dev, generator=g)
    kp = torch.arange(T, dtype=torch.int32, device=dev).repeat(B, 1)
    qp = kp[:, T - S:].clone()
    if case == "no_key_rows":
        kp[1] = 2**30                  # row 1: every key an empty slot
        kp[2] += 5                     # row 2: its first 5 queries see none
    up = torch.randn(B * S * H * D + 1, device=dev, generator=g)
    up = (up[1:] if case == "dout_off_16_bytes" else up[:-1]).view(
        B, S, H, D)
    _, got, _ = _hold_k3e(q, k, v, qp.contiguous(), kp.contiguous(), up,
                          causal=causal)
    if case == "no_key_rows":
        dq, dk, dv = got
        assert not dq[1].any() and not dk[1].any() and not dv[1].any()
        assert not dq[2, :5].any() and dq[2, 5:].abs().max() > 0


def test_train_attention_refuses_decode_and_int8(dev):
    q = torch.randn((1, 1, 8, 64), device=dev, requires_grad=True)
    k = torch.randn((1, 16, 1, 64), device=dev)
    pos = torch.arange(16, device=dev, dtype=torch.int32)[None]
    with pytest.raises(NotImplementedError, match="decode"):
        ops.chunked_attention(q, k, k, pos[:, -1:], pos)
    qi = torch.randn((1, 4, 8, 64), device=dev, requires_grad=True)
    ki = torch.zeros((1, 16, 1, 64), device=dev, dtype=torch.int8)
    sc = torch.ones((1, 16, 1), device=dev)
    with pytest.raises(NotImplementedError, match="int8"):
        ops.chunked_attention(qi, ki, ki, pos[:, :4], pos, k_scale=sc,
                              v_scale=sc)
    with torch.no_grad():                  # serving: no grad, the kernel
        n = ops.FA.chunked_attention.launches
        ops.chunked_attention(qi, k, k, pos[:, :4], pos)
        assert ops.FA.chunked_attention.launches == n + 1


def test_train_step_on_card_matches_cpu(dev):
    """Reduced tinyllama: 3 train steps on the card (K3e in its forward)
    from the CPU run's params and batches give the CPU run's losses within
    1e-4 and K3 prefill launches = layers x steps."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import lm
    from repro_torch.optim.adamw import OptConfig, tree_map
    from repro_torch.train import step as TS

    cfg = get_reduced("tinyllama-1.1b")
    pcfg = TS.ParallelConfig(fsdp=False)
    ocfg = OptConfig(lr=8e-3, warmup_steps=2, total_steps=40)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4,
                      repeat_len=8)
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = TS.make_train_step(cfg, pcfg, ocfg)
    cpu = TS.state_from_params(params, pcfg)
    card = TS.state_from_params(tree_map(lambda p: p.to(dev), params), pcfg)
    n = ops.FA.chunked_attention.prefill
    for i in range(3):
        cpu, mc = step(cpu, batch_at(dcfg, i, device="cpu"))
        card, mg = step(card, batch_at(dcfg, i, device=dev))
        assert abs(float(mc["loss"]) - float(mg["loss"])) < 1e-4
    assert ops.FA.chunked_attention.prefill == n + 3 * cfg.n_layers


@pytest.mark.parametrize("shape,dt,pairs", [
    ((8, 5), torch.uint8, [(i, (i + 1) % 8) for i in range(8)]),  # 5 B
    ((4, 3, 3), torch.float32, [(0, 2), (3, 1)]),      # 36 B: padded row
    ((1, 1000), torch.float32, [(0, 0)]),              # n = 1
    ((4, 64, 32), torch.bfloat16, [(2, 2), (0, 1)]),   # src == dst
    ((8, 4096), torch.int32, [(7, 0)]),                # rows of 1 KiB
])
def test_stacked_hop_matches_plain_gather(dev, shape, dt, pairs):
    """A StackedAxis hop on the card is one K2 launch, bit-equal to the
    same hop on the CPU (the plain gather of the same table): shards whose
    bytes are no multiple of 16 go through a padded staging row, n = 1 and
    a device sending to itself included; a device receiving nothing gets
    zeros."""
    from repro_torch.launch.mesh import StackedAxis
    g = torch.Generator(device=dev).manual_seed(31)
    x = torch.randn(shape, device=dev, generator=g).mul(50).to(dt)
    card, cpu = StackedAxis(shape[0], device=dev), StackedAxis(shape[0],
                                                                device="cpu")
    n = ops.RC.villa_gather.launches
    got = card.ppermute(x, pairs)
    torch.cuda.synchronize()
    assert ops.RC.villa_gather.launches == n + 1
    want = cpu.ppermute(x.cpu(), pairs)
    assert got.dtype == dt and got.shape == x.shape
    assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8))
    # the view of a stack off a 16-byte boundary is staged as well
    off = torch.randn((shape[0] * x[0].numel() + 1,), device=dev,
                      generator=g).to(dt)[1:].view(shape)
    assert torch.equal(card.ppermute(off, pairs).cpu().view(torch.uint8),
                       cpu.ppermute(off.cpu(), pairs).view(torch.uint8))


def test_rbm_and_plans_on_card_match_cpu(dev):
    """lisa_copy, lisa_broadcast and the ring collectives over a
    StackedAxis on the card equal the CPU's run bit for bit, and the
    migration plan's pools land as the numpy oracle with one K2 launch a
    hop plus the gather's and one K1."""
    from repro_torch import movement as MV
    from repro_torch.core.lisa import rbm
    from repro_torch.core.lisa.topology import MeshTopology
    from repro_torch.launch.mesh import StackedAxis
    g = torch.Generator(device=dev).manual_seed(32)
    x = torch.randn((8, 3, 129), device=dev, generator=g)
    card, cpu = StackedAxis(8, device=dev), StackedAxis(8, device="cpu")
    for fn in (lambda a, t: rbm.lisa_copy(t, 1, 6, a),
               lambda a, t: rbm.lisa_copy(t, 6, 1, a, wraparound=False),
               lambda a, t: rbm.lisa_broadcast(t, 3, a, dsts=[0, 5, 7]),
               lambda a, t: rbm.ring_allgather(t, a, dim=1),
               lambda a, t: rbm.ring_allreduce(t, a),
               lambda a, t: rbm.ring_reduce_scatter(
                   t[:, :, :128].reshape(8, 8, 48), a)):
        assert torch.equal(fn(card, x).cpu(), fn(cpu, x.cpu()))
    ax = StackedAxis(4, device=dev, name="replica")
    pool = torch.randint(0, 256, (4, 16, 8, 128), dtype=torch.uint8,
                         device=dev, generator=g)
    st, dt = [1, 4, 15], [0, 2, 5]
    want = pool.cpu().numpy().copy()
    want[2][dt] = want[0][st]
    plan = MV.plan(MV.Transfer(MV.Tier("slow", index=0, axis="replica"),
                               MV.Tier("slow", index=2, axis="replica"),
                               MV.Layout.raw_pages(3, 8, 128, np.uint8)),
                   topo=MeshTopology(4))
    ops.reset_launch_counts()
    MV.execute(plan, src_pool=pool, src_table=st, dst_pool=pool,
               dst_table=dt, axes={"replica": ax})
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert np.array_equal(pool.cpu().numpy(), want)
    assert (counts["villa_gather"], counts["villa_scatter"]) == \
        (1 + plan.legs[1].hops, 1)


def test_two_axis_stacked_hop_matches_plain_gather(dev):
    """A hop along one axis of a 2 x 3 stacked mesh on the card is one K2
    launch over the whole stack, its pairs applied in every group, bit-equal
    to the CPU's (the plain gather of the same table), with 20-byte shards
    (no multiple of 16: a padded staging row)."""
    from repro_torch.launch.mesh import make_local_mesh
    g = torch.Generator(device=dev).manual_seed(33)
    x = torch.randn((6, 5), device=dev, generator=g)
    card = make_local_mesh(2, 3, device=dev)
    cpu = make_local_mesh(2, 3, device="cpu")
    for name, pairs in (("model", [(0, 1), (1, 2)]),
                        ("model", [(i, (i + 1) % 3) for i in range(3)]),
                        ("data", [(0, 1), (1, 0)]), ("data", [(1, 0)])):
        n = ops.RC.villa_gather.launches
        got = card.axis(name).ppermute(x, pairs)
        torch.cuda.synchronize()
        assert ops.RC.villa_gather.launches == n + 1
        want = cpu.axis(name).ppermute(x.cpu(), pairs)
        assert torch.equal(got.cpu().view(torch.uint8),
                           want.view(torch.uint8)), (name, pairs)


def test_mesh_train_step_on_card_matches_cpu(dev):
    """Reduced tinyllama on a 2 x 2 stacked mesh (fsdp, tensor_parallel),
    3 steps on the card against the same steps on the CPU: step 1's loss
    and grad norm within rel 1e-5, its params within 1e-5 where the CPU's
    gradient is above 1e-6 and within lr everywhere, every loss within rel
    1e-4; K3 prefill launches layers a step (one forward of the folded
    stack, its heads split over the model axis), and the K2 launches
    equal the mesh's hops."""
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import shardings as SH
    from repro_torch.train import step as TS

    cfg = get_reduced("tinyllama-1.1b")
    pcfg = TS.ParallelConfig(fsdp=True)
    ocfg = OptConfig(lr=8e-3, warmup_steps=2, total_steps=40)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8,
                      repeat_len=8)
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = TS.state_from_params(params, pcfg)
    runs = {}
    for where in ("cpu", dev):
        mesh = make_local_mesh(2, 2, device=where)
        _, compile_step, state_shardings = TS.make_train_step(cfg, mesh,
                                                              pcfg, ocfg)
        sh = state_shardings(state)
        step = compile_step(state, batch_at(dcfg, 0, device=where))
        st = SH.shard(state, sh)
        hist = []
        ops.reset_launch_counts()
        mesh.reset_counts()
        for i in range(3):
            st, m = step(st, batch_at(dcfg, i, device=where))
            hist.append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0:
                first = SH.unshard(st, sh)
        if where == dev:
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            hops = sum(h for h, _ in mesh.counts().values())
            assert counts["villa_gather"] == hops
            assert counts["flash_attention_prefill"] == 3 * cfg.n_layers
        runs[str(where)] = (hist, first)
    (hc, fc), (hg, fg) = runs["cpu"], runs[str(dev)]
    assert hg[0][0] == pytest.approx(hc[0][0], rel=1e-5)
    assert hg[0][1] == pytest.approx(hc[0][1], rel=1e-5)
    for (a, _), (b, _) in zip(hg, hc):
        assert a == pytest.approx(b, rel=1e-4)
    grads = dict(_flatten(TS.grads_of(cfg, pcfg, params,
                                      batch_at(dcfg, 0, device="cpu"))[2]))
    for (path, c), (_, g) in zip(_flatten(fc.params), _flatten(fg.params)):
        diff = (g.cpu() - c).abs()
        assert (diff[grads[path].abs() > 1e-6] <= 1e-5).all(), path
        assert (diff <= ocfg.lr).all(), path


@pytest.mark.parametrize("arch,shape,kw", [
    ("tinyllama-1.1b", (1, 4), {}),
    ("tinyllama-1.1b", (2, 2), {"sequence_parallel": True}),
    ("olmoe-1b-7b", (2, 2), {"moe_groups": 2})])
def test_split_train_and_serve_steps_on_card_match_cpu(dev, arch, shape,
                                                       kw):
    """The model axis's split compute on the card against the same on the
    CPU: one train step (loss and grad norm within rel 1e-5, params within
    1e-5 where the gradient is above 1e-6 and within lr everywhere), then
    a prefill of 4 x 24 tokens and 6 greedy decode steps through
    ``make_prefill_step``/``make_serve_step`` over a laid-out cache
    (logits within 1e-4, greedy tokens equal); K3 once a layer for the
    whole stack on each route, K2 == the hops."""
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import shardings as SH
    from repro_torch.train import step as TS
    cfg = get_reduced(arch)
    pcfg = TS.ParallelConfig(**kw)
    ocfg = OptConfig(lr=8e-3, warmup_steps=2, total_steps=40)
    params = lm.init_lm(cfg, torch.Generator().manual_seed(1), device="cpu")
    g = torch.Generator().manual_seed(2)
    t = torch.randint(0, cfg.vocab_size, (8, 33), generator=g,
                      dtype=torch.int32)
    batch = {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}
    prompt = torch.randint(0, cfg.vocab_size, (4, 24), generator=g,
                           dtype=torch.int32)
    runs = {}
    for where in ("cpu", dev):
        mesh = make_local_mesh(*shape, device=where)
        on = {k: v.to(where) for k, v in batch.items()}
        p = SH.tree_map(lambda x: x.to(where), params)
        state = TS.state_from_params(p, pcfg)
        _, compile_step, state_shardings = TS.make_train_step(cfg, mesh,
                                                              pcfg, ocfg)
        sh = state_shardings(state)
        ops.reset_launch_counts()
        mesh.reset_counts()
        st, m = compile_step(state, on)(SH.shard(state, sh), on)
        if where == dev:
            torch.cuda.synchronize()
            c = ops.launch_counts()
            assert c["flash_attention_prefill"] == cfg.n_layers
            assert c["villa_gather"] == sum(
                h for h, _ in mesh.counts().values())
        full = SH.unshard(st, sh).params
        cache = lm.init_cache(cfg, 4, 40, device=where)
        _, pcomp = TS.make_prefill_step(cfg, mesh, pcfg)
        _, scomp = TS.make_serve_step(cfg, mesh, pcfg)
        ps = SH.tree_shardings(p, mesh, SH.param_spec)
        cs = SH.tree_shardings(cache, mesh, SH.cache_spec)
        lg_sh = TS._logits_sharding(cfg, mesh, 4)
        laid_p, laid_c = SH.shard(p, ps), SH.shard(cache, cs, stack_dim=1)
        pb = {"tokens": prompt.to(where)}
        ops.reset_launch_counts()
        mesh.reset_counts()
        lg, laid_c = pcomp(p, cache, pb)(laid_p, laid_c, pb)
        logits = [SH.unshard({"l": lg}, {"l": lg_sh})["l"].cpu()]
        tok = logits[0][:, -1:].argmax(-1).to(torch.int32)
        toks = [tok]
        sstep = scomp(p, cache, tok.to(where))
        for i in range(6):
            lg, laid_c = sstep(laid_p, laid_c, tok.to(where), 24 + i)
            logits.append(SH.unshard({"l": lg}, {"l": lg_sh})["l"].cpu())
            tok = logits[-1][:, -1:].argmax(-1).to(torch.int32)
            toks.append(tok)
        if where == dev:
            torch.cuda.synchronize()
            c = ops.launch_counts()
            assert c["flash_attention_prefill"] == cfg.n_layers
            assert c["flash_attention_decode"] == 6 * cfg.n_layers
            assert c["villa_gather"] == sum(
                h for h, _ in mesh.counts().values())
        runs[str(where)] = (m, full, logits, toks)
    (mc, fc, lc, tc), (mg, fg, lgpu, tg) = runs["cpu"], runs[str(dev)]
    assert float(mg["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-5)
    assert float(mg["grad_norm"]) == pytest.approx(float(mc["grad_norm"]),
                                                   rel=1e-5)
    grads = dict(_flatten(TS.grads_of(cfg, pcfg, params, batch)[2]))
    for (path, c), (_, gp) in zip(_flatten(fc), _flatten(fg)):
        diff = (gp.cpu() - c).abs()
        assert (diff[grads[path].abs() > 1e-6] <= 1e-5).all(), path
        assert (diff <= ocfg.lr).all(), path
    for a, b in zip(lgpu, lc):
        assert float((a - b).abs().max()) <= 1e-4
    for a, b in zip(tg, tc):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "rwkv6-7b"])
def test_split_families_serve_steps_on_card_match_cpu(dev, arch):
    """MLA and rwkv split over ``model`` on a 1 x 2 stacked mesh on the
    card against the same on the CPU: reduced deepseek-v2 at its full
    MLA head dims (Dk 192 / Dv 128, the K3 instantiation the full model
    takes) and reduced rwkv6, a prefill of 4 x 24 tokens and 6 greedy
    decode steps through ``make_prefill_step``/``make_serve_step`` over
    a laid-out cache (logits within 1e-4, greedy tokens equal); K3's
    prefill route once a layer over each device's local heads (MLA's
    decode runs its absorbed einsums, rwkv no K3), K2 == the hops."""
    import dataclasses

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.train import shardings as SH
    from repro_torch.train import step as TS
    cfg = get_reduced(arch)
    if cfg.kv_lora_rank:
        full = get_config(arch)
        cfg = dataclasses.replace(
            cfg, qk_nope_dim=full.qk_nope_dim, qk_rope_dim=full.qk_rope_dim,
            v_head_dim=full.v_head_dim,
            head_dim=full.qk_nope_dim + full.qk_rope_dim)
    pcfg = TS.ParallelConfig()
    params = lm.init_lm(cfg, torch.Generator().manual_seed(4), device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (4, 24), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(5))
    heads = []
    real = ops.chunked_attention

    def spy(q, *a, **kw):
        heads.append(q.shape[2])
        return real(q, *a, **kw)
    runs = {}
    for where in ("cpu", dev):
        mesh = make_local_mesh(1, 2, device=where)
        p = SH.tree_map(lambda x: x.to(where), params)
        cache = lm.init_cache(cfg, 4, 40, device=where)
        _, pcomp = TS.make_prefill_step(cfg, mesh, pcfg)
        _, scomp = TS.make_serve_step(cfg, mesh, pcfg)
        ps = SH.tree_shardings(p, mesh, SH.param_spec)
        cs = SH.tree_shardings(cache, mesh, SH.cache_spec)
        lg_sh = TS._logits_sharding(cfg, mesh, 4)
        laid_p, laid_c = SH.shard(p, ps), SH.shard(cache, cs, stack_dim=1)
        pb = {"tokens": prompt.to(where)}
        ops.reset_launch_counts()
        mesh.reset_counts()
        heads.clear()
        ops.chunked_attention = spy
        try:
            lg, laid_c = pcomp(p, cache, pb)(laid_p, laid_c, pb)
            logits = [SH.unshard({"l": lg}, {"l": lg_sh})["l"].cpu()]
            tok = logits[0][:, -1:].argmax(-1).to(torch.int32)
            toks = [tok]
            sstep = scomp(p, cache, tok.to(where))
            for i in range(6):
                lg, laid_c = sstep(laid_p, laid_c, tok.to(where), 24 + i)
                logits.append(SH.unshard({"l": lg}, {"l": lg_sh})["l"].cpu())
                tok = logits[-1][:, -1:].argmax(-1).to(torch.int32)
                toks.append(tok)
        finally:
            ops.chunked_attention = real
        if where == dev:
            torch.cuda.synchronize()
            c = ops.launch_counts()
            mla = sum(k == "mla" for k in cfg.layer_kinds())
            assert c["flash_attention_prefill"] == mla
            assert c["flash_attention_decode"] == 0
            assert heads == [cfg.n_heads // 2] * mla
            assert c["villa_gather"] == sum(
                h for h, _ in mesh.counts().values())
        runs[str(where)] = (logits, toks)
    (lc, tc), (lgpu, tg) = runs["cpu"], runs[str(dev)]
    for a, b in zip(lgpu, lc):
        assert float((a - b).abs().max()) <= 1e-4
    for a, b in zip(tg, tc):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the entry-point audit on the card (repro_torch.analysis)
# ---------------------------------------------------------------------------

def test_card_audit_counts_syncs_launches_and_allocations(dev):
    """On the card the audit counts each synchronising call (the sync
    debug mode's warnings, not the one that says the mode is a
    prototype), each kernel's launches and what a call allocates."""
    from repro_torch.analysis import dispatch as D
    from repro_torch.analysis.dispatch import AuditTarget, EntryContract

    pool = torch.zeros((64, 8, 128), dtype=torch.uint8, device=dev)
    table = torch.arange(8, dtype=torch.int32, device=dev)
    state = {"pool": pool}

    def target(fn, **contract):
        return AuditTarget("fixture", fn, (), EntryContract(**contract),
                           state=lambda: state)

    rec, findings = D.audit_target(target(
        lambda: ops.villa_gather(pool, table),
        launches={"villa_gather": 1}), dev)
    assert findings == [] and rec["syncs"] == 0
    assert rec["launches"]["villa_gather"] == 1
    for leak in (lambda: pool.sum().item(), lambda: pool[:1].cpu(),
                 lambda: pool.nonzero()):
        rec, findings = D.audit_target(target(leak), dev)
        assert [f.rule for f in findings] == ["audit-host-transfer"]
        assert rec["syncs"] >= 1
    rec, findings = D.audit_target(target(
        lambda: state.__setitem__("pool", pool.clone()),
        inplace=frozenset({"pool"})), dev)
    assert sorted(f.rule for f in findings) == ["audit-alloc",
                                                "audit-inplace"]
    assert rec["alloc_bytes"] >= pool.numel()


def test_card_audit_of_the_default_targets_is_clean(dev):
    """Every registered entry point at reduced geometry on the card:
    launches as its contract says (a wave's as one call's), no sync, state
    in place (its tensors kept), no uint8 page widened.  The allocation
    bound (``audit-alloc``) is left to chip_smoke phase 25 at serving
    geometry: the reduced store of 4 snapshots is smaller than a suspend's
    int32 widening of one snapshot for its checksums."""
    from repro_torch.analysis import dispatch as D
    from repro_torch.analysis import entrypoints as E

    targets, engine = E.default_targets(device=dev)
    audit = D.run_audit(targets, device=dev, extra_findings=(
        D.audit_bucket_stability(engine, E.prefill_buckets(engine))))
    assert [f for f in audit["findings"] if f["rule"] != "audit-alloc"] \
        == []
    by = {t["name"]: t for t in audit["targets"]}
    assert by["suspend_many"]["launches"] == by["suspend"]["launches"]
    assert by["resume_many"]["launches"] == by["resume"]["launches"]
    assert all(t["syncs"] == 0 for t in audit["targets"])


# ---------------------------------------------------------------------------
# the tiered store's waves on the card (one launch set a wave)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_store_waves_on_card_match_the_loop_on_cpu(dev, seed):
    """access_many/write_many on the card (K2 and K1 for the whole wave)
    against a loop of access/write on the CPU over random waves of 1-6
    items, with duplicates and evictions inside a wave: data, hits and
    the whole store agree after every wave.  The CPU loop is held to the
    reference in tests/test_torch_villa.py."""
    from repro_torch.core.dram.villa import VillaConfig
    from repro_torch.core.lisa import villa_cache as PC

    cfg = VillaConfig(n_counters=8, n_hot=2, n_slots=3, epoch_len=5)
    rng = np.random.default_rng(200 + seed)
    slow0 = torch.from_numpy(rng.integers(0, 256, (6, 3, 8, 128),
                                          dtype=np.uint8))
    card = PC.make_store(slow0.to(dev), cfg)
    host = PC.make_store(slow0.clone(), cfg)

    def same():
        for a, b in zip(tuple(card.policy) + (card.fast, card.slow,
                                              card.hits, card.accesses),
                        tuple(host.policy) + (host.fast, host.slow,
                                              host.hits, host.accesses)):
            assert torch.equal(a.cpu(), b)

    for _ in range(30):
        k = int(rng.integers(1, 7))
        items = rng.integers(0, 6, k).astype(np.int32)
        if rng.random() < 0.7:
            card, data, hits = PC.access_many(card, items, cfg)
            want_d, want_h = [], []
            for item in items:
                host, d, h = PC.access(host, int(item), cfg)
                want_d.append(d.clone())
                want_h.append(bool(h))
            assert torch.equal(data.cpu(), torch.stack(want_d))
            assert hits.cpu().tolist() == want_h
        else:
            data = torch.from_numpy(rng.integers(0, 256, (k, 3, 8, 128),
                                                 dtype=np.uint8))
            card = PC.write_many(card, items, data.to(dev))
            for item, d in zip(items, data):
                host = PC.write(host, int(item), d)
        same()


def test_capture_attributes_the_region_whole(dev):
    """``roofline.attribution.capture``: the region's launches each have
    their device record (the lead-in takes what the session drops), and
    only the region's are counted."""
    from repro_torch.roofline import attribution as AT
    x = torch.ones(1 << 20, device=dev)

    def region():
        for _ in range(5):
            x.mul_(1.0)
        x.cpu()
    _, att = AT.capture(region)
    assert att["unrecorded"] == 0
    assert (att["launches"], att["copies"]) == (5, 1)
    assert att["kernel_ms"] > 0 and att["lead_in_unrecorded"] >= 0


# ---- K2 over sparse tables; the all-bf16 prefill route --------------------

def _sparse_tables(dev, g, n, n_pool):
    """Tables of ``n`` entries over ``n_pool`` pages: every entry live,
    none, one live run of n / 8 at a random offset (a one-pair hop's),
    and scattered live entries (one in ten)."""
    live = torch.randint(0, n_pool, (n,), device=dev, generator=g,
                         dtype=torch.int32)
    run = torch.full_like(live, -1)
    m = max(1, n // 8)
    off = int(torch.randint(0, n - m + 1, (1,), device=dev, generator=g))
    run[off:off + m] = live[off:off + m]
    scattered = torch.where(torch.rand(n, device=dev, generator=g) < 0.1,
                            live, torch.full_like(live, -1))
    return {"all": live, "dead": torch.full_like(live, -1), "run": run,
            "scattered": scattered}


@pytest.mark.parametrize("page_bytes", [16, 48, 1024, 4096, 4112, 8208,
                                        65536])
def test_gather_sparse_tables_bit_exact(dev, page_bytes):
    """K2 bit-exact against villa_gather_ref over tables mostly -1 (one
    live run at a random offset, scattered live entries), all live and all
    -1, at pages of 16 B to 64 KiB (8208 B: an 8 KiB unit and a 16-byte
    tail): a masked read leaves out[j] as it was where the entry is -1."""
    g = torch.Generator(device=dev).manual_seed(page_bytes)
    n_pool = max(16, (16 << 20) // page_bytes)
    pages = torch.randint(0, 256, (n_pool, page_bytes), dtype=torch.uint8,
                          device=dev, generator=g)
    for n in (1, 33, 3001 if page_bytes <= 8208 else 257):
        for name, table in _sparse_tables(dev, g, n, n_pool).items():
            out = torch.randint(0, 256, (n, page_bytes), dtype=torch.uint8,
                                device=dev, generator=g)
            got = ops.villa_gather(pages, table, out=out.clone())
            want = ref.villa_gather_ref(pages, table, out.clone())
            assert torch.equal(got, want), (n, name)
            dead = table < 0
            assert torch.equal(got[dead], out[dead]), (n, name)
            if name == "all":
                assert torch.equal(ops.villa_gather(pages, table),
                                   pages[table.long()]), n


def test_gather_sparse_table_longer_than_the_grid(dev):
    """A hop's table shape: 1 KiB and 64 KiB rows, far more batches than
    the persistent grid takes in one pass, most entries -1."""
    g = torch.Generator(device=dev).manual_seed(29)
    for page_bytes, n in ((1024, 400_003), (65536, 6_007)):
        n_pool = (64 << 20) // page_bytes
        pages = torch.randint(0, 256, (n_pool, page_bytes),
                              dtype=torch.uint8, device=dev, generator=g)
        for name, table in _sparse_tables(dev, g, n, n_pool).items():
            if name == "all":
                continue
            out = torch.zeros((n, page_bytes), dtype=torch.uint8,
                              device=dev)
            got = ops.villa_gather(pages, table, out=out.clone())
            assert torch.equal(got, ref.villa_gather_ref(pages, table,
                                                         out.clone())), name


def _bf16_case(dev, seed, B, S, T, H, K, dk, dv, ragged=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, S, H, dk), device=dev, generator=g).to(BF16)
    k = torch.randn((B, T, K, dk), device=dev, generator=g).to(BF16)
    v = torch.randn((B, T, K, dv), device=dev, generator=g).to(BF16)
    kp = torch.arange(T, dtype=torch.int32, device=dev).repeat(B, 1)
    qp = kp[:, T - S:].clone()
    if ragged:                       # row b holds T - 37 b - 5 tokens
        for b in range(B):
            n = T - 37 * b - 5
            kp[b, n:] = 2**30
            qp[b] = torch.arange(n - S, n, device=dev, dtype=torch.int32)
        qp[:, -3:] = 2**30           # and its last 3 queries are pads
    return q, k, v, qp.contiguous(), kp.contiguous()


@pytest.mark.parametrize("B,S,T,H,K,dk,dv,window,causal", [
    (1, 300, 300, 32, 4, 64, 64, 0, True),          # width 64, G 8
    (2, 77, 150, 12, 4, 56, 56, 0, True),           # 56 in width 64, G 3
    (1, 300, 400, 8, 2, 120, 120, 50, True),        # 120 in 128, window
    (1, 1500, 1500, 32, 16, 128, 128, 1024, True),  # gemma3's window
    (1, 1024, 1024, 16, 16, 256, 256, 0, True),     # gemma-7b
    (1, 333, 333, 32, 32, 224, 224, 0, True),       # Zamba2: 224 in 256
    (2, 300, 400, 8, 2, 256, 256, 100, True),       # width 256, window
    (1, 1024, 1024, 16, 16, 192, 128, 0, True),     # MLA's Dk / Dv
    (2, 40, 64, 64, 64, 192, 128, 0, True),         # MLA, S below a CTA
    (2, 37, 200, 64, 2, 128, 128, 0, True),         # G 32
    (1, 9, 50, 400, 2, 128, 128, 0, True),          # G 200: head slices
    (2, 200, 512, 8, 8, 64, 64, 0, False),          # non-causal
    (1, 33, 1024, 16, 4, 128, 128, 0, False),       # non-causal, G 4
])
def test_wgmma_prefill_matches_plain(dev, B, S, T, H, K, dk, dv, window,
                                     causal):
    """All-bf16 prefill runs the wgmma route (its counter, inside the
    prefill route's) and stays within ref.attention_bar of the plain
    version: each width (64, 128, 256, padded head dims in them) and MLA,
    S and T off the 128-key tiles, windows, G 1 to 200, non-causal (at T
    up to or a multiple of the reference's 512-key blocks, whose padding
    it counts as keys in non-causal attention)."""
    q, k, v, qp, kp = _bf16_case(dev, dk + H + S, B, S, T, H, K, dk, dv)
    before = (ops.FA.chunked_attention.prefill,
              ops.FA.chunked_attention.prefill_wgmma)
    out = ops.chunked_attention(q, k, v, qp, kp, window=window,
                                causal=causal)
    torch.cuda.synchronize()
    assert (ops.FA.chunked_attention.prefill,
            ops.FA.chunked_attention.prefill_wgmma) == (before[0] + 1,
                                                        before[1] + 1)
    want = ref.chunked_attention_ref(q, k, v, qp, kp, window=window,
                                     causal=causal)
    _assert_within_bar(out, want, q, k, v, qp, kp, window=window,
                       causal=causal)


@pytest.mark.parametrize("dk,dv,G", [(64, 64, 8), (128, 128, 4),
                                     (224, 224, 1), (192, 128, 1)])
def test_wgmma_prefill_ragged_rows_and_pads(dev, dk, dv, G):
    """B = 3 rows of different lengths (2**30 past each row's tokens) and
    query pads at 2**30, on the wgmma route, within the bar."""
    q, k, v, qp, kp = _bf16_case(dev, dk + G, 3, 64, 300, 4 * G, 4, dk, dv,
                                 ragged=True)
    n = ops.FA.chunked_attention.prefill_wgmma
    out = ops.chunked_attention(q, k, v, qp, kp)
    assert ops.FA.chunked_attention.prefill_wgmma == n + 1
    want = ref.chunked_attention_ref(q, k, v, qp, kp)
    _assert_within_bar(out, want, q, k, v, qp, kp)


@pytest.mark.parametrize("off", [1, 3])
def test_wgmma_prefill_of_views_off_16_byte_boundaries(dev, off):
    """q, k and v views that start off a 16-byte boundary: the wrapper
    copies them, and the route's TMA maps read the copies."""
    g = torch.Generator(device=dev).manual_seed(off)
    shapes = ((1, 100, 8, 64), (1, 100, 2, 64), (1, 100, 2, 64))
    q, k, v = (torch.randn((math.prod(s) + off,), device=dev,
                           generator=g).to(BF16)[off:].view(s)
               for s in shapes)
    pos = torch.arange(100, dtype=torch.int32, device=dev)[None]
    n = ops.FA.chunked_attention.prefill_wgmma
    out = ops.chunked_attention(q, k, v, pos, pos)
    assert ops.FA.chunked_attention.prefill_wgmma == n + 1
    want = ref.chunked_attention_ref(q, k, v, pos, pos)
    _assert_within_bar(out, want, q, k, v, pos, pos)


@pytest.mark.parametrize("B,S,H,K,D", [(2, 77, 8, 8, 64), (1, 130, 16, 4, 128),
                                       (1, 90, 8, 8, 224)])
def test_train_attention_on_the_wgmma_route(dev, B, S, H, K, D):
    """K3e over bf16 q, k, v: the forward is one launch of the wgmma route
    within the bar of the plain twin (writing the log-sum-exp), and the
    backward kernel's bf16 dq/dk/dv come within 2x the bf16 twin's own
    relative L2 gap to the twin in f64, bit-equal call to call
    (_hold_k3e)."""
    q, k, v, pos, _ = _bf16_case(dev, D + S, B, S, S, H, K, D, D)
    up = torch.randn((B, S, H, D), device=dev).to(BF16)
    _hold_k3e(q, k, v, pos, pos, up)
