"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a GPU (decided in the fixture, at
run time).  On a machine with one, run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

They cover shapes the smoke run does not: odd page counts, masked and
out-of-range page tables, tables longer than the page gather's persistent
grid, other head dims (256 included), group sizes and dtypes (q over k/v
of another dtype included), sequence lengths that are not multiples of the
kernels' tiles or splits, the decode kernel's dispatch
rule, and the Engine on the card against the Engine on the CPU.
"""
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
    """More entries than the resident warps take in one pass (132 SMs x at
    most 64 warps x 4 pages), 16-byte pages and 1 KiB pages."""
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


def test_attention_still_raises_outside_its_shapes(dev):
    q = torch.zeros((1, 4, 2, 512), device=dev)
    pos = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim 512"):
        ops.chunked_attention(q, q, q, pos, pos, window=2)
    q = torch.zeros((1, 4, 2, 64), device=dev)
    with pytest.raises(NotImplementedError, match="Dv != Dk"):
        ops.chunked_attention(q, q, q[..., :32].contiguous(), pos, pos)


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

