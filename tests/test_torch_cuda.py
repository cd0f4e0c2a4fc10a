"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a GPU (decided in the fixture, at
run time).  On a machine with one, run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

They cover shapes the smoke run does not: odd page counts, other head
dims, group sizes and dtypes, sequence lengths that are not multiples of the
kernel's tiles, and the Engine on the card against the Engine on the CPU.
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
    tol = 2e-2 if dt == torch.bfloat16 else 3e-5
    assert float((out.float() - want.float()).abs().max()) < tol
    full = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=False)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=False)
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
    tol = 2e-2 if dt == torch.bfloat16 else 3e-5
    assert float((out.float() - want.float()).abs().max()) < tol
    assert ops.KERNELS["flash_attention"].launches == n + 1
    if S > 1:
        full = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), window=window)
        want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), window=window)
        assert float((full.float() - want.float()).abs().max()) < tol


def test_attention_still_raises_outside_its_shapes(dev):
    q = torch.zeros((1, 4, 2, 256), device=dev)
    pos = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim 256"):
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
