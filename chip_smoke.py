#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc`` with
nvcc (sm_90a), then:

  1. device   — requires CUDA; prints the card's name and power limit;
  2. kernels  — holds each kernel against its plain PyTorch version on the
                card at the shapes of phases 3 and 5-9 (page gather/scatter
                and the tile copy bit-exact, the gather also as a masked
                read into an existing buffer; attention within 3e-5 where
                its output is f32, and where it is bf16 within bf16's
                rounding of the same result (never 2e-2), at max_len
                1024 and at the launcher's 256; at gemma3's: a 1500-token
                prefill with window 1024 and without, decode over 1024-slot
                rings whose positions have wrapped and over the 2048-slot
                global cache, these also with bf16 q over f32 K/V; at
                gemma-7b's head dim 256: decode over its cache and prefill
                of a long and a short bucket in f32 and bf16; every decode
                shape through the split-KV kernel), the tile copy also on
                odd shapes, dtypes and sizes, and times kernel, plain
                version and one library call for the same function;
  3. serving  — full-width tinyllama-1.1b (random weights from a seed)
                through ``Engine``: 8 requests, 32 decode steps, a suspend
                wave of 4 sessions, one resume wave, decode to completion;
                a suspended-and-resumed request must yield exactly the
                tokens of the same request decoded uninterrupted, no resume
                may fail its checksums, the stats must add up, and every
                kernel's launch counter, reset just before the measured
                Engine and read after its last step, must equal what that
                run's stats call for (and so be above 0);
  3b. tile_copy — every leaf of that Engine's live KV cache goes through a
                device->device ``movement`` transfer (the ``tile_copy`` leg,
                K4): each copy bit-exact and a new tensor, and K4's counter,
                reset just before, equal to the number of executes;
  4. numbers  — serving and per-kernel times, each tagged with the card
                (a kernel's, its plain version's and its library call's
                times, the host's time to run the wrapper included where it
                outlasts the L2 flush, as in every earlier run; beside
                them the kernel's and the library call's device time, that
                host time hidden behind a GPU sleep, and the host's us to
                queue one call), and a decode profile;
  5. launcher — ``python -m repro_torch.launch.serve`` (the scheduler over
                the Engine) at full width, once plain and once with
                ``--fork-prefix`` and ``--trace-out``: every job completes,
                the stats and the resume waves add up, no resume fails its
                checksums, each kernel's counter (reset before each run)
                equals what the run's stats call for, K4 is not launched,
                and the trace parses as Chrome trace JSON;
  6. gemma3   — full-width gemma3-27b cut to 14 layers (f32, 28.8 GB of
                random weights from a seed: the 62 layers, 108 GB, do not
                fit), sliding-window layers with 1024-slot ring caches:
                the Engine (4 slots, max_len 2048, prompts of 96-1500
                tokens, a suspend and a resume wave of the two longest;
                tokens must equal an uninterrupted run, no resume may fail
                its checksums, the stats must add up, each launch counter
                must equal what the stats call for), its numbers and a
                decode profile, then the Scheduler over a fresh Engine with
                prompts past the window (every job completes, resumes equal
                the resume waves' widths, the counters add up, K4 is not
                launched);
  7. gemma-7b — full width and depth (28 layers, head dim 256, f32, 34.2
                GB), K3 at head dim 256: the Engine and the Scheduler, held
                as in phase 6;
  8. gemma3 62 layers — all of gemma3-27b with bf16 weights (54 GB) over
                the Engine's f32 cache: bf16 prefill, decode with bf16 q
                over f32 K/V; the Engine and the Scheduler, as in phase 6;
  9. qwen1.5  — qwen1.5-110b at full width with bf16 weights, cut to 8 of
                its 80 layers (26.8 GB; 80 are 222 GB): the Engine with one
                suspend and one resume wave.

Each phase prints its wall time.  The last line of standard output is
``{"ok": true, "device": {...}}``; any failure exits non-zero before it.
Imports torch, numpy and repro_torch only.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12         # H100 SXM tensor cores, dense TF32
BF16_FLOP_PER_S = 989e12         # H100 SXM tensor cores, dense bf16
SLEEP_CYCLES = 400_000           # ~0.2 ms of GPU sleep ahead of a timing
SLOTS, MAX_LEN, N_SESSIONS, SEED = 8, 1024, 32, 0
SERVE_LEN = 256                  # the launcher's --max-len in phase 5
# phase 6: gemma3-27b at full width, cut to 14 layers (two 6-layer periods
# and the 2-layer local tail, so both stages run): 7.19 B f32 parameters,
# 28.8 GB, where all 62 layers (27.0 B, 108 GB) do not fit in 80 GB
G_LAYERS, G_SLOTS, G_MAX_LEN, G_SESSIONS = 14, 4, 2048, 16
G_PROMPTS, G_MAX_NEW, G_FIRST = (96, 700, 1010, 1500), 48, 24
G_SCHED_LENS = (300, 1100)       # the Scheduler run's prompt lengths
# phase 7: gemma-7b at full width and depth (28 layers, head dim 256, MHA):
# 8.54 B f32 parameters, 34.2 GB; K/V take 32 KB a token a layer, so 4
# slots at max_len 1024 hold 3.8 GB and a store of 8 sessions (and its fast
# tier of 2) 9.4 GB
D7_SLOTS, D7_MAX_LEN, D7_SESSIONS = 4, 1024, 8
D7_PROMPTS, D7_MAX_NEW, D7_FIRST = (40, 200, 333, 700), 48, 24
D7_SCHED_LENS = (100, 600)
# phase 8: gemma3-27b at all 62 layers, bf16 weights (54 GB) over the
# Engine's f32 cache: a max_len-2048 slot holds (10 x 2048 + 52 x 1024)
# token-layers x 16 KB = 1.21 GB, so 4 slots take 4.8 GB and the store 6
# sessions (and its fast tier of 2), 9.7 GB
G62_SESSIONS = 6
# phase 9: qwen1.5-110b at full width, bf16 weights, cut to 8 of 80 layers
# (13.4 B parameters, 26.8 GB)
Q_LAYERS, Q_SLOTS, Q_MAX_LEN, Q_SESSIONS = 8, 4, 1024, 8
Q_PROMPTS, Q_MAX_NEW, Q_FIRST = (24, 150, 400, 800), 24, 12


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def timed(fn, reps=20, flush=None, device=False):
    """Median ms of ``fn`` over ``reps`` calls between CUDA events, after
    warm-up; ``flush`` runs before each call, outside the timed window.
    The start event is recorded before ``fn``'s Python runs, so the window
    holds the host's time to queue the kernels wherever it outlasts the
    flush on the card.  With ``device=True`` a GPU sleep queued ahead of
    the start event keeps the card busy while the host runs ``fn``, and the
    window holds the device time of the kernels alone."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        if device:
            torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: chip_smoke runs on a GPU only")
    import numpy as np
    from repro_torch import movement as MV
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import lm
    from repro_torch.movement import paging
    from repro_torch.serve.engine import Engine, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    tag = card()
    print(f"card: {tag}  torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- build ---------------------------------------------------------
    t_start = t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name in sorted(built):
        log = (_build.BUILD_DIR / f"{name}.log").read_text()
        entry, info = "", []
        for line in log.splitlines():
            m = re.search(r"entry function '([^']+)'", line)
            if m:
                entry, info = kernel_name(m.group(1)), []
            if "spill" in line:
                info.append(line.split(":", 1)[-1].strip())
            if "registers" in line:
                info.append(line.split(":", 1)[-1].strip())
                print(f"  ptxas {name} {entry}: {'; '.join(info)}")
    check_sass(built)
    lap = [time.perf_counter()]

    def wall(phase):
        now = time.perf_counter()
        print(f"phase {phase}: {now - lap[0]:.1f} s wall")
        lap[0] = now

    cfg = get_config("tinyllama-1.1b")
    spec = paging.PageSpec.for_cache(lm.init_cache(cfg, 1, MAX_LEN,
                                                   device=dev))
    n_pages, page = spec.n_pages, spec.page_bytes
    print(f"snapshot: {spec.total_bytes} B = {n_pages} pages of {page} B")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush = lambda: scratch.fill_(1)         # noqa: E731  (evict L2)
    rows = {}

    # ---- phase 2: kernels against their plain versions -------------------
    pool = torch.randint(0, 256, (N_SESSIONS * n_pages, 8, 128),
                         dtype=torch.uint8, device=dev, generator=gen)
    table = paging.row_page_table(spec, 7).to(dev)
    got = ops.villa_gather(pool, table)
    check(torch.equal(got, ref.villa_gather_ref(pool, table)),
          "villa_gather differs from index_select")

    def masked_gather(tab, label):
        """K2 as the resume path calls it: -1 entries keep out's rows."""
        tab = tab.clone()
        tab[::5] = -1
        before = torch.randint(0, 256, (tab.numel(), 8, 128),
                               dtype=torch.uint8, device=dev, generator=gen)
        got = ops.villa_gather(pool, tab, out=before.clone())
        check(torch.equal(got, ref.villa_gather_ref(pool, tab,
                                                    before.clone()))
              and torch.equal(got[::5], before[::5]),
              f"villa_gather's masked read differs at {label}")

    masked_gather(table, f"{n_pages} pages")
    idx = table.long()
    nbytes = 2 * n_pages * page + 4 * n_pages
    rows["villa_gather"] = dict(
        **kernel_times(lambda: ops.villa_gather(pool, table),
                       lambda: ref.villa_gather_ref(pool, table),
                       lambda: pool.index_select(0, idx), flush),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        max_abs_err=0.0)

    upd = torch.randint(0, 256, (n_pages, 8, 128), dtype=torch.uint8,
                        device=dev, generator=gen)
    wtab = paging.row_page_table(spec, 5).to(dev)
    check(torch.equal(ops.villa_scatter(pool.clone(), wtab, upd),
                      ref.villa_scatter_ref(pool.clone(), wtab, upd)),
          "villa_scatter differs from its plain version at the path shape")
    for dt in (torch.uint8, torch.float32, torch.bfloat16, torch.int8):
        small = torch.randn((4096, 8, 128), device=dev,
                            generator=gen).mul(50).to(dt)
        upd2 = torch.randn((1500, 8, 128), device=dev,
                           generator=gen).mul(50).to(dt)
        t = torch.randint(0, 512, (1500,), device=dev, generator=gen,
                          dtype=torch.int32)       # many duplicates
        t[::7] = -1                                # skips
        a = ops.villa_scatter(small.clone(), t, upd2)
        b = ref.villa_scatter_ref(small.clone(), t, upd2)
        check(torch.equal(a.view(torch.uint8), b.view(torch.uint8)),
              f"villa_scatter ({dt}) differs: duplicates / -1 skips")
    # the launcher's snapshot (phase 5 serves at max_len SERVE_LEN)
    spec_s = paging.PageSpec.for_cache(lm.init_cache(cfg, 1, SERVE_LEN,
                                                     device=dev))
    rtab = paging.row_page_table(spec_s, 3).to(dev)
    check(torch.equal(ops.villa_gather(pool, rtab),
                      ref.villa_gather_ref(pool, rtab)),
          f"villa_gather differs at the max_len {SERVE_LEN} snapshot")
    masked_gather(rtab, f"the max_len {SERVE_LEN} snapshot")
    upd_s = upd[:spec_s.n_pages].contiguous()
    check(torch.equal(ops.villa_scatter(pool.clone(), rtab, upd_s),
                      ref.villa_scatter_ref(pool.clone(), rtab, upd_s)),
          f"villa_scatter differs at the max_len {SERVE_LEN} snapshot")
    print(f"villa_gather/villa_scatter: bit-exact at {n_pages} and "
          f"{spec_s.n_pages} pages, the gather also as a masked read")
    widx = wtab.long()
    rows["villa_scatter"] = dict(
        **kernel_times(lambda: ops.villa_scatter(pool, wtab, upd),
                       lambda: ref.villa_scatter_ref(pool, wtab, upd),
                       lambda: pool.index_copy_(0, widx, upd), flush),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        max_abs_err=0.0)
    del pool, upd, small, upd2

    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(SEED)

    def attn_case(B, S, T, lens, dtype=torch.float32, empty_row=False):
        q = torch.randn((B, S, H, D), device=dev, generator=gen).to(dtype)
        k = torch.randn((B, T, K, D), device=dev, generator=gen).to(dtype)
        v = torch.randn((B, T, K, D), device=dev, generator=gen).to(dtype)
        kv_pos = np.full((B, T), 2**30, np.int32)
        q_pos = np.full((B, S), 2**30, np.int32)
        for b, n in enumerate(lens):
            kv_pos[b, :n] = np.arange(n)
            if S == 1:
                q_pos[b, 0] = n - 1
            else:
                q_pos[b, :n] = np.arange(n)      # prefill: pads at 2**30
        if empty_row:
            kv_pos[0] = 2**30                    # batch row 0: no valid key
            q_pos[0] = 0
        return (q, k, v, torch.from_numpy(q_pos).to(dev),
                torch.from_numpy(kv_pos).to(dev), lens)

    def attn_err(case):
        q, k, v, qp, kp, _ = case
        out = ops.chunked_attention(q, k, v, qp, kp)
        err, _ = attention_err(f"{tuple(q.shape)} x {tuple(k.shape)} "
                               f"{q.dtype}", out, q, k, v, qp, kp)
        return err, out

    errs = []
    for bucket in (16, 64, 256):
        case = attn_case(1, bucket, bucket, [int(rng.integers(bucket // 2 + 1,
                                                              bucket + 1))])
        errs.append(attn_err(case)[0])
        print(f"attention prefill bucket {bucket}: max_abs_err {errs[-1]:.3g}")
    # phase 5's shapes: the forked 24-token prefix prefills in bucket 32,
    # and decode attends over the launcher's max_len
    errs.append(attn_err(attn_case(1, 32, 32, [24]))[0])
    print(f"attention prefill bucket 32 (24 valid): max_abs_err "
          f"{errs[-1]:.3g}")
    slens = [int(x) for x in rng.integers(7, 57, SLOTS)]
    errs.append(attn_err(attn_case(SLOTS, 1, SERVE_LEN, slens,
                                   empty_row=True))[0])
    print(f"attention decode S=1 T={SERVE_LEN} B={SLOTS}: max_abs_err "
          f"{errs[-1]:.3g}")
    dlens = [int(x) for x in rng.integers(17, 333, SLOTS)]
    dec = attn_case(SLOTS, 1, MAX_LEN, dlens, empty_row=True)
    err, out = attn_err(dec)
    check(not out[0].any(), "a row with no valid key must give 0")
    errs.append(err)
    _, groups, n_split, split_len = FA.decode_plan(
        SLOTS, K, H // K, MAX_LEN, 4,
        torch.cuda.get_device_properties(dev).multi_processor_count, D)
    print(f"attention decode S=1 T={MAX_LEN} B={SLOTS}: max_abs_err {err:.3g}"
          f"; {n_split} splits of {split_len} slots, "
          f"{n_split * groups * K * SLOTS} CTAs")
    bf = attn_case(2, 64, 64, [40, 64], dtype=torch.bfloat16)
    print(f"attention bf16 prefill 64: max_abs_err {attn_err(bf)[0]:.3g}")

    dec = attn_case(SLOTS, 1, MAX_LEN, dlens)
    q, k, v, qp, kp, _ = dec
    sdpa_mask = (kp[:, None, None, :] <= qp[:, None, :, None])
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = lambda: sdpa(qt, kt, vt, attn_mask=sdpa_mask,  # noqa: E731
                           enable_gqa=True)
    bound, by = attention_bound(q, k, qp, kp, 0)
    rows["flash_attention"] = dict(
        **kernel_times(lambda: ops.chunked_attention(q, k, v, qp, kp),
                       lambda: ref.chunked_attention_ref(q, k, v, qp, kp),
                       library, flush),
        bound_ms=bound, bound_by=by, max_abs_err=max(errs))
    rows["flash_attention_prefill"] = prefill_rows(attn_case, flush, tag)
    rows["flash_attention_window"] = window_attention_rows(dev, gen, flush,
                                                           tag)
    rows["flash_attention_d256"], rows["flash_attention_mixed"] = \
        wide_and_mixed_rows(dev, gen, flush, tag)

    # K4 at the tile_copy path's shape: one K leaf of the serving cache
    leaf = torch.randn((cfg.n_layers, SLOTS, MAX_LEN, K, D), device=dev,
                       generator=gen)
    got, want = ops.rbm_copy(leaf), ref.rbm_copy_ref(leaf)
    check(bit_equal(got, want),
          f"rbm_copy differs from its plain version at {tuple(leaf.shape)}")
    copy_err = float((got - want).abs().max())
    del got, want
    odd = [((1000, 333), torch.float32), ((7, 129, 65), torch.bfloat16),
           ((4096,), torch.int32), ((256, 128), torch.int8),
           ((13,), torch.uint8), ((0,), torch.float32),
           ((3, 5, 7), torch.bool)]
    for shape, dt in odd:
        x = torch.randn(shape, device=dev, generator=gen).mul(60).to(dt)
        got = ops.rbm_copy(x, tile_rows=64)
        check(got.shape == x.shape and got.dtype == x.dtype
              and bit_equal(got, ref.rbm_copy_ref(x, tile_rows=64))
              and bit_equal(got, x), f"rbm_copy differs at {shape} {dt}")
    skew = torch.randint(0, 256, (100_003,), dtype=torch.uint8, device=dev,
                         generator=gen)[1:]          # not 16-byte aligned
    check(bit_equal(ops.rbm_copy(skew), ref.rbm_copy_ref(skew)),
          "rbm_copy differs on a misaligned view")
    print(f"rbm_copy: bit-exact at {tuple(leaf.shape)} f32 and on "
          f"{len(odd) + 1} odd cases")
    c_bytes = 2 * leaf.numel() * leaf.element_size()
    rows["rbm_copy"] = dict(
        **kernel_times(lambda: ops.rbm_copy(leaf),
                       lambda: ref.rbm_copy_ref(leaf), lambda: leaf.clone(),
                       flush),
        bound_ms=c_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        max_abs_err=copy_err)
    del scratch, leaf
    torch.cuda.synchronize()
    wall(2)

    # ---- phase 3: full-width serving through the Engine ------------------
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    torch.cuda.synchronize()
    print(f"params: {sum(t.numel() for t in _leaves(params))} f32 "
          f"in {time.perf_counter() - t0:.1f} s")
    lens = [int(x) for x in np.random.default_rng(SEED).integers(16, 301, 8)]
    prompts = [np.random.default_rng(SEED + 1 + i).integers(
        0, cfg.vocab_size, n).astype(np.int32) for i, n in enumerate(lens)]
    max_new, first_steps, wave = 48, 32, [1, 3, 5, 7]

    solo = Engine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                  n_sessions=N_SESSIONS, device=dev)
    solo_reqs = [Request(uid, p, max_new) for uid, p in enumerate(prompts)]
    for r in solo_reqs:
        solo.submit(r)
    while solo.active:
        solo.step()
    # warm the resume path (policy ops, masked page moves) once, so the
    # timed waves below measure steady state, not first-use module loads
    solo.resume_many([0, 1, 2, 3], 2)
    while solo.active:
        solo.step()

    # the counters cover the measured engine alone, up to its last step
    ops.reset_launch_counts()
    eng = Engine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                 n_sessions=N_SESSIONS, device=dev)
    reqs = [Request(uid, p, max_new) for uid, p in enumerate(prompts)]
    prefill_ms = {}
    for r in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.submit(r)                        # ends in the next-token read
        prefill_ms.setdefault(eng._bucket_len(len(r.prompt)), []).append(
            (time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(first_steps):
        eng.step()                           # each ends in its token read
    decode_s = time.perf_counter() - t0
    held = {s: eng.active[s] for s in wave}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.suspend_many(wave)
    torch.cuda.synchronize()
    suspend_s = time.perf_counter() - t0
    uids = [held[s].uid for s in wave]
    extra = [max_new - len(held[s].generated) + 1 for s in wave]
    t0 = time.perf_counter()
    slots = eng.resume_many(uids, extra)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    resumed = {eng.active[s].uid: eng.active[s] for s in slots}
    while eng.active:
        eng.step()
    counts = ops.launch_counts()

    for r, s in zip(reqs, solo_reqs):
        got = (r.generated + resumed[r.uid].generated[1:]
               if r.uid in resumed else r.generated)
        check(len(s.generated) == max_new and got == s.generated,
              f"uid {r.uid}: tokens differ from the uninterrupted run")
    check(eng.verify_failure_count() == 0, "a resume failed its checksums")
    check(int(eng.verify_store()) == 0, "the session store fails its scrub")
    st = eng.stats
    n_susp, n_res = len(wave) + len(reqs), len(wave)
    check(st["prefills"] == 8 and st["suspends"] == n_susp
          and st["resumes"] == n_res, f"stats counts: {st}")
    check(st["decoded_tokens"] == len(reqs) * (max_new - 1),
          f"decoded_tokens {st['decoded_tokens']}")
    check(st["decode_dispatches"] == st["host_transfers"], "one read a step")
    want = (n_susp * eng.plan_suspend.cost.ns_lisa
            + n_res * eng.plan_resume.cost.ns_lisa)
    check(math.isclose(st["modeled_move_ns_lisa"], want, rel_tol=1e-9),
          "modeled movement does not add up")
    check_counts(counts, serving_launches(cfg, st), "the Engine's path")
    print(f"serving: tokens match the uninterrupted run for all 8 requests "
          f"({len(wave)} suspended+resumed); stats {json.dumps(st)}")

    # ---- phase 3b: the tile_copy leg over the live KV cache --------------
    ops.reset_launch_counts()
    executes = 0
    for x in paging.cache_leaves(eng.cache):         # k, pos, v
        np_dtype = np.dtype(str(x.dtype).removeprefix("torch."))
        p = MV.plan(MV.Transfer(MV.Tier("device"), MV.Tier("device"),
                                MV.Layout.dense(x.shape, np_dtype)))
        check([leg.kind for leg in p.legs] == ["tile_copy"],
              f"device->device plan: {p.legs}")
        out = MV.execute(p, data=x)["data"]
        executes += 1
        check(out.untyped_storage().data_ptr()
              != x.untyped_storage().data_ptr(), "tile_copy aliased its source")
        check(out.shape == x.shape and out.dtype == x.dtype
              and bit_equal(out, x), f"tile_copy differs on {tuple(x.shape)}")
    torch.cuda.synchronize()
    check_counts(ops.launch_counts(), {"rbm_copy": executes}, "tile_copy")
    counts["rbm_copy"] = executes
    print(f"tile_copy: {executes} live cache leaves copied bit-exact through "
          f"movement.execute")
    wall("3-3b")

    # ---- phase 4: numbers ----------------------------------------------
    snap = eng.snapshot_bytes
    print(f"decode: {first_steps} steps x {SLOTS} slots, "
          f"{decode_s / first_steps * 1e3:.3f} ms/step, "
          f"{first_steps * SLOTS / decode_s:.1f} tok/s [{tag}]")
    for b in sorted(prefill_ms):
        print(f"prefill bucket {b}: {statistics.median(prefill_ms[b]):.3f} ms "
              f"(n={len(prefill_ms[b])}) [{tag}]")
    print(f"suspend wave of {len(wave)}: {suspend_s * 1e3:.3f} ms, "
          f"{len(wave) * snap / suspend_s / 1e9:.2f} GB/s [{tag}]")
    print(f"resume wave of {len(wave)}: {resume_s * 1e3:.3f} ms, "
          f"{len(wave) * snap / resume_s / 1e9:.2f} GB/s [{tag}]")
    profile_decode(eng, tag)
    del eng, solo
    torch.cuda.empty_cache()
    wall(4)

    # ---- phase 5: scheduler-driven serving through the launcher ----------
    for run in serve_runs(tag):
        for name, n in run.items():
            counts[name] += n
    wall(5)

    # ---- phases 6-9: gemma3-27b (14 layers, f32), gemma-7b (f32),
    # gemma3-27b (62 layers, bf16 weights), qwen1.5-110b (bf16 weights) ---
    del params
    torch.cuda.empty_cache()
    paths = {}
    for phase, (entry, fn) in enumerate(
            (("flash_attention_window", gemma3_phase),
             ("flash_attention_d256", gemma7b_phase),
             ("flash_attention_mixed", gemma3_bf16_phase),
             ("flash_attention_mixed", qwen_phase)), start=6):
        run = fn(tag)
        for name in ("villa_scatter", "villa_gather", "rbm_copy"):
            counts[name] += run[name]
        k3 = paths.setdefault(entry, {"prefill": 0, "decode": 0})
        k3["prefill"] += run["flash_attention_prefill"]
        k3["decode"] += run["flash_attention_decode"]
        wall(phase)
    routes = {"flash_attention": {"prefill": counts["flash_attention_prefill"],
                                  "decode": counts["flash_attention_decode"]},
              **paths}
    for entry, k3 in paths.items():
        counts[entry] = k3["prefill"] + k3["decode"]
    # K3 on tinyllama's paths by route: the decode row, then the prefill row
    counts["flash_attention"] = counts["flash_attention_decode"]

    replaces = {
        "villa_scatter": "src/repro/kernels/rbm_copy.py:93",
        "villa_gather": "src/repro/kernels/rbm_copy.py:58",
        "flash_attention": "src/repro/kernels/flash_attention.py:81",
        "flash_attention_window": "src/repro/kernels/flash_attention.py:81",
        "flash_attention_prefill": "src/repro/kernels/flash_attention.py:81",
        "flash_attention_d256": "src/repro/kernels/flash_attention.py:81",
        "flash_attention_mixed": "src/repro/kernels/flash_attention.py:81",
        "rbm_copy": "src/repro/kernels/rbm_copy.py:27"}
    csrc = "src/repro_torch/kernels/csrc/"
    decode_src = csrc + "flash_decode.cu"
    sources = {"villa_scatter": csrc + "page_copy.cu",
               "villa_gather": csrc + "page_copy.cu",
               "flash_attention": decode_src,
               "flash_attention_window": decode_src,
               "flash_attention_prefill": csrc + "flash_attention.cu",
               "flash_attention_d256": decode_src,
               "flash_attention_mixed": decode_src,
               "rbm_copy": csrc + "rbm_copy.cu"}
    # flash_attention counts K3's decode kernel on the tinyllama paths
    # (phases 3 and 5), flash_attention_prefill its prefill kernel there;
    # flash_attention_window both on gemma3's 14-layer f32 path (phase 6),
    # flash_attention_d256 both on gemma-7b's (phase 7), and
    # flash_attention_mixed both on the bf16-weight paths (phases 8, 9:
    # bf16 prefill, bf16 q over the f32 cache in decode), by route beside,
    # with the dtypes each route ran there; a row's source is its headline
    # route's (the prefill kernel is csrc/flash_attention.cu)
    kernels = []
    for name in ("villa_scatter", "villa_gather", "flash_attention",
                 "flash_attention_prefill", "flash_attention_window",
                 "flash_attention_d256", "flash_attention_mixed",
                 "rbm_copy"):
        r = rows[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": sources[name], "replaces": replaces[name],
                        "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
        kernels[-1].update({key: r[key] for key in
                            ("device_ms", "library_device_ms", "enqueue_us",
                             "library_enqueue_us", "tc_bound_ms", "dtypes",
                             "library_operands", "shapes")
                            if key in r})
        if name in routes:
            kernels[-1]["launches_by_route"] = routes[name]
        if name == "flash_attention_mixed":
            kernels[-1]["route_dtypes"] = {
                "prefill": "q bfloat16, k/v bfloat16 (shapes: "
                           "prefill_local_bf16)",
                "decode": "q bfloat16, k/v float32 (shapes: decode_ring, "
                          "decode_global, qwen_decode)"}
        print(f"kernel {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), launches "
              f"{counts[name]}; device time: kernel {r['device_ms']:.4f} "
              f"ms, library {r['library_device_ms']:.4f} ms; host to queue "
              f"a call: kernel {r['enqueue_us']:.1f} us, library "
              f"{r['library_enqueue_us']:.1f} us [{tag}]")
    print(f"all phases: {time.perf_counter() - t_start:.1f} s wall after "
          f"the build started")
    print(json.dumps({"kernels": kernels}))
    print(tag)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_times(kernel, plain, library, flush) -> dict:
    """The times of one path shape: the kernel's, its plain version's and
    the library call's ms as every run has timed them (``timed``); the
    kernel's and the library call's device ms (``timed(device=True)``);
    and the host's us a call to queue each (``enqueue_us``)."""
    return dict(ms=timed(kernel, flush=flush),
                plain_ms=timed(plain, flush=flush),
                library_ms=timed(library, flush=flush),
                device_ms=timed(kernel, flush=flush, device=True),
                library_device_ms=timed(library, flush=flush, device=True),
                enqueue_us=enqueue_us(kernel),
                library_enqueue_us=enqueue_us(library))


def enqueue_us(fn, calls=50) -> float:
    """Host us a call of ``fn`` takes to return, its kernels queued but
    not run: ``calls`` calls back to back on the host clock, the card
    synchronised before and after, outside the window."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def attention_err(label, got, q, k, v, qp, kp, window=0):
    """K3's output ``got`` against its plain version on the same inputs,
    element by element under ``ref.attention_bar`` (3e-5 where the output
    is f32; where it is bf16, 3e-5 plus two bf16 ulps of the value, plus
    2**-8 of the attention over |v| where the prefill's products are bf16,
    never past 2e-2).  Returns (max abs error, the largest error's share of
    its bar); fails the run past the bar."""
    from repro_torch.kernels import ref

    want = ref.chunked_attention_ref(q, k, v, qp, kp, window=window)
    bar = ref.attention_bar(got, want, q, k, v, qp, kp, window=window)
    diff = (got.float() - want.float()).abs()
    share = float((diff / bar).max())
    check(got.dtype == q.dtype and share <= 1,
          f"attention {label}: error {float(diff.max())} past its bar "
          f"({share:.3g} of it, {got.dtype})")
    return float(diff.max()), share


def attention_bound(q, k, q_pos, kv_pos, window, peak=F32_FLOP_PER_S,
                    passes=1):
    """(ms, "bytes" or "operations") of the least time the card could take
    for this attention: q read and the output written once (in q's dtype),
    positions read once, the K/V rows that some query of their batch row
    attends read once (in k's dtype); 4*H*D FLOP per valid (query, key)
    pair, at the f32 peak (or,
    for the prefill kernel's own bound, ``passes`` products of each at a
    tensor-core peak: 3 TF32 ones for f32, one bf16)."""
    qp, kp = q_pos.cpu().numpy(), kv_pos.cpu().numpy()
    valid = kp[:, None, :] <= qp[:, :, None]
    if window > 0:
        valid &= kp[:, None, :] > qp[:, :, None] - window
    B, S, H, D = q.shape
    K = k.shape[2]
    nbytes = (q.element_size() * 2 * q.numel()
              + k.element_size() * 2 * int(valid.any(1).sum()) * K * D
              + 4 * (qp.size + kp.size))
    flops = 4 * H * D * int(valid.sum()) * passes
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def tc_bound(q, k, q_pos, kv_pos, window):
    """The prefill kernel's tensor-core bound (ms): one bf16 product when
    q and K/V are bf16, else 3xTF32 (any f32 operand takes that path)."""
    import torch
    if q.dtype == torch.bfloat16 and k.dtype == torch.bfloat16:
        return attention_bound(q, k, q_pos, kv_pos, window,
                               BF16_FLOP_PER_S)[0]
    return attention_bound(q, k, q_pos, kv_pos, window, TF32_FLOP_PER_S,
                           3)[0]


def prefill_rows(attn_case, flush, tag) -> dict:
    """Phase 2's tinyllama prefill shapes (the Engine's buckets 16 and 512,
    a full prompt): the prefill kernel within 3e-5 of its plain version,
    timed beside it and SDPA (causal boolean mask), with its f32 and
    tensor-core bounds.  Returns the ``kernels`` entry: bucket 512's
    numbers, both buckets' in ``shapes``."""
    import torch
    from repro_torch.kernels import ops, ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for bucket in (16, 512):
        q, k, v, qp, kp, _ = attn_case(1, bucket, bucket, [bucket])
        got = ops.chunked_attention(q, k, v, qp, kp)
        want = ref.chunked_attention_ref(q, k, v, qp, kp)
        err = float((got - want).abs().max())
        check(err <= 3e-5, f"prefill bucket {bucket}: error {err} > 3e-5")
        mask = kp[:, None, None, :] <= qp[:, None, :, None]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        bound, by = attention_bound(q, k, qp, kp, 0)
        r = out[f"bucket_{bucket}"] = dict(
            **kernel_times(lambda: ops.chunked_attention(q, k, v, qp, kp),
                           lambda: ref.chunked_attention_ref(q, k, v, qp, kp),
                           lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                        enable_gqa=True), flush),
            bound_ms=bound, bound_by=by, tc_bound_ms=tc_bound(q, k, qp, kp, 0),
            max_abs_err=err)
        print(f"attention prefill bucket {bucket}: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, "
              f"bound {bound:.5f} ms ({by}), tensor-core bound "
              f"{r['tc_bound_ms']:.5f} ms; device time: kernel "
              f"{r['device_ms']:.4f} ms, SDPA {r['library_device_ms']:.4f} ms;"
              f" max_abs_err {err:.3g} [{tag}]")
    row = dict(out["bucket_512"])
    row["max_abs_err"] = max(r["max_abs_err"] for r in out.values())
    row["shapes"] = out
    return row


def check_sass(built) -> None:
    """The compiled code shows the design: every kernel of the prefill
    library is an instantiation of the prefill kernel running tensor-core
    MMAs (HMMA); every kernel of the decode library one of the split-KV
    kernel; K4 issues bulk copies (UBLKCP).  Prints how many instantiations
    each library holds.  Reads the SASS with the toolkit's cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for name in ("flash_attention", "flash_decode", "rbm_copy"):
        sass = subprocess.run([tool, "-sass", str(built[name])],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        fn = None
        lib = counts[name] = {}
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = kernel_name(m.group(1))
                lib[fn] = {"HMMA": 0, "UBLKCP": 0}
            elif fn is not None:
                for op in ("HMMA", "UBLKCP"):
                    lib[fn][op] += op in line
    prefill, decode = counts["flash_attention"], counts["flash_decode"]
    check(prefill and all("prefill_kernel" in k and c["HMMA"] > 0
                          for k, c in prefill.items()),
          f"prefill kernels without tensor-core MMAs or outside the design: "
          f"{prefill}")
    check(decode and all("decode_split_kernel" in k for k in decode),
          f"decode library outside the design: {sorted(decode)}")
    bulk = [c["UBLKCP"] for k, c in counts["rbm_copy"].items()
            if "bulk_copy" in k]
    check(bulk and all(n > 0 for n in bulk), "K4 issues no bulk copies")
    for k in sorted(prefill):
        print(f"  sass {k}: {prefill[k]['HMMA']} HMMA")
    print(f"  sass: {len(prefill)} prefill kernels, all with HMMA; "
          f"{len(decode)} split-KV decode kernels; bulk_copy_kernel: "
          f"{bulk[0]} UBLKCP")


def window_attention_rows(dev, gen, flush, tag) -> dict:
    """Phase 2 at gemma3-27b's attention shapes (32 q / 16 kv heads, head
    dim 128, window 1024), which phase 6 launches: K3 against its plain
    version (``attention_err``) in f32 and in bf16 for a 1500-token prefill
    (local, window 1024, and global), a ragged decode of 4 rows over 1024-
    slot rings whose positions have wrapped (slot t % 1024 holds token t),
    and over the 2048-slot global cache; each f32 shape timed beside its
    plain version, SDPA with the boolean (window) mask and its bound.
    Returns the ``kernels`` entry: the ring decode's numbers (12 of the 14
    layers launch it every decode step) and every shape's in ``shapes``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref

    cfg = get_config("gemma3-27b")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    H, K, D, W = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.window
    ends = np.array(G_PROMPTS) + G_MAX_NEW - 1   # the last decode's positions
    B, P = len(ends), max(G_PROMPTS)
    prefill = np.arange(P, dtype=np.int32)[None]
    ring = np.full((B, W), 2**30, np.int32)
    glob = np.full((B, G_MAX_LEN), 2**30, np.int32)
    for b, n in enumerate(ends):
        t = np.arange(max(0, n - W + 1), n + 1)
        ring[b, t % W] = t
        glob[b, :n + 1] = np.arange(n + 1)
    wrapped = [b for b in range(B) if ends[b] >= W and (ends[b] + 1) % W]
    check(wrapped and all((np.diff(ring[b]) < 0).any() for b in wrapped),
          "the ring positions did not wrap")
    shapes = {  # name: (q_pos, kv_pos, window, check bf16 too)
        "prefill_local": (prefill, prefill, W, True),
        "prefill_global": (prefill, prefill, 0, False),
        "decode_ring": (ends[:, None].astype(np.int32), ring, W, True),
        "decode_global": (ends[:, None].astype(np.int32), glob, 0, False),
        "decode_global_windowed": (ends[:, None].astype(np.int32), glob, W,
                                   False)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name, (qp_np, kp_np, window, bf16) in shapes.items():
        nb, S = qp_np.shape
        T = kp_np.shape[1]
        qp = torch.from_numpy(qp_np).to(dev)
        kp = torch.from_numpy(kp_np).to(dev)
        q = torch.randn((nb, S, H, D), device=dev, generator=gen)
        k = torch.randn((nb, T, K, D), device=dev, generator=gen)
        v = torch.randn((nb, T, K, D), device=dev, generator=gen)
        plan = ""
        if S == 1:
            gc, groups, n_split, split_len = FA.decode_plan(
                nb, K, H // K, T, k.element_size(), n_sm, D)
            plan = (f", {n_split} splits of {split_len} slots, "
                    f"{n_split * groups * K * nb} CTAs")
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            if dt == torch.bfloat16 and not bf16:
                continue
            args = (q.to(dt), k.to(dt), v.to(dt), qp, kp)
            got = ops.chunked_attention(*args, window=window)
            errs[str(dt).removeprefix("torch.")] = attention_err(
                f"{name} window {window}", got, *args, window)[0]
        print(f"attention {name} S={S} T={T} B={nb} window {window}{plan}: "
              f"max_abs_err {errs}")
        if name == "decode_global_windowed":
            continue                  # a check only: no layer launches it
        mask = kp[:, None, None, :] <= qp[:, None, :, None]
        if window > 0:
            mask &= kp[:, None, None, :] > qp[:, None, :, None] - window
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        bound, by = attention_bound(q, k, qp, kp, window)
        out[name] = dict(
            **kernel_times(
                lambda: ops.chunked_attention(q, k, v, qp, kp,
                                              window=window),
                lambda: ref.chunked_attention_ref(q, k, v, qp, kp,
                                                  window=window),
                lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True),
                flush),
            bound_ms=bound, bound_by=by, max_abs_err=errs["float32"],
            max_abs_err_bf16=errs.get("bfloat16"))
        r = out[name]
        if S > 1:
            r["tc_bound_ms"] = tc_bound(q, k, qp, kp, window)
        if name == "prefill_local":         # bf16, a finding beside SDPA's
            qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
            qbt, kbt, vbt = (x.transpose(1, 2) for x in (qb, kb, vb))
            r["bf16"] = dict(
                ms=timed(lambda: ops.chunked_attention(qb, kb, vb, qp, kp,
                                                       window=window),
                         flush=flush),
                device_ms=timed(lambda: ops.chunked_attention(
                    qb, kb, vb, qp, kp, window=window), flush=flush,
                    device=True),
                library_device_ms=timed(lambda: sdpa(
                    qbt, kbt, vbt, attn_mask=mask, enable_gqa=True),
                    flush=flush, device=True),
                tc_bound_ms=tc_bound(qb, kb, qp, kp, window))
            print(f"attention {name} bf16: kernel {r['bf16']['ms']:.4f} ms, "
                  f"device {r['bf16']['device_ms']:.4f} ms, SDPA device "
                  f"{r['bf16']['library_device_ms']:.4f} ms, tensor-core "
                  f"bound {r['bf16']['tc_bound_ms']:.5f} ms [{tag}]")
        print(f"attention {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound "
              f"{bound:.5f} ms ({by}); device time: kernel "
              f"{r['device_ms']:.4f} ms, SDPA {r['library_device_ms']:.4f} ms; "
              f"host to queue a call: kernel {r['enqueue_us']:.1f} us, SDPA "
              f"{r['library_enqueue_us']:.1f} us [{tag}]")
    row = {k: v for k, v in out["decode_ring"].items()
           if k != "max_abs_err_bf16"}
    for name in ("prefill_local", "prefill_global"):
        print(f"attention {name}: device {out[name]['device_ms']:.4f} ms "
              f"against the target of 50% of the f32 bound "
              f"({2 * out[name]['bound_ms']:.4f} ms); tensor-core bound "
              f"{out[name]['tc_bound_ms']:.4f} ms [{tag}]")
    row["max_abs_err"] = max(r["max_abs_err"] for r in out.values())
    row["shapes"] = out
    return row


def attention_row(label, q, k, v, qp, kp, window, flush, tag) -> dict:
    """One attention shape: the kernel held to its plain version
    (``attention_err``), then timed beside it and SDPA
    (``enable_gqa``, boolean mask), with its bound (operations at the
    bf16 peak when q and K/V are bf16, else at the f32 peak) and, for a
    prefill, its tensor-core bound.  SDPA takes one dtype: a mixed row's
    operands are promoted to f32 before its timed window."""
    import torch
    from repro_torch.kernels import ops, ref

    got = ops.chunked_attention(q, k, v, qp, kp, window=window)
    err, share = attention_err(label, got, q, k, v, qp, kp, window)
    mixed = q.dtype != k.dtype
    lq, lk, lv = ((x.float() if mixed else x).transpose(1, 2)
                  for x in (q, k, v))
    mask = kp[:, None, None, :] <= qp[:, None, :, None]
    if window > 0:
        mask &= kp[:, None, None, :] > qp[:, None, :, None] - window
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # the operations at the peak of the products' type: bf16 only when q
    # and K/V are both bf16 (an f32 operand promotes the product)
    bf16 = q.dtype == k.dtype == torch.bfloat16
    bound, by = attention_bound(q, k, qp, kp, window,
                                BF16_FLOP_PER_S if bf16 else F32_FLOP_PER_S)
    r = dict(**kernel_times(
        lambda: ops.chunked_attention(q, k, v, qp, kp, window=window),
        lambda: ref.chunked_attention_ref(q, k, v, qp, kp, window=window),
        lambda: sdpa(lq, lk, lv, attn_mask=mask, enable_gqa=True), flush),
        bound_ms=bound, bound_by=by, max_abs_err=err, err_share_of_bar=share,
        dtypes=f"q {str(q.dtype)[6:]}, k/v {str(k.dtype)[6:]}")
    if mixed:
        r["library_operands"] = "promoted to float32 outside its timed window"
    if q.shape[1] > 1:
        r["tc_bound_ms"] = tc_bound(q, k, qp, kp, window)
    print(f"attention {label} ({r['dtypes']}) S={q.shape[1]} T={k.shape[1]} "
          f"B={q.shape[0]} window {window}: max_abs_err {err:.3g} "
          f"({share:.3g} of its bar); kernel "
          f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA "
          f"{r['library_ms']:.4f} ms, bound {bound:.5f} ms ({by})"
          + (f", tensor-core bound {r['tc_bound_ms']:.5f} ms"
             if "tc_bound_ms" in r else "")
          + f"; device time: kernel {r['device_ms']:.4f} ms, SDPA "
          f"{r['library_device_ms']:.4f} ms [{tag}]")
    return r


def wide_and_mixed_rows(dev, gen, flush, tag):
    """Phase 2 at the shapes phases 7-9 launch and no earlier phase does.
    Head dim 256 at gemma-7b's (16 heads, MHA): decode over its D7_MAX_LEN
    cache for D7_SLOTS rows, and the prefill of the buckets of its longest
    and shortest prompts (700 tokens in 1024, 40 in 64), in f32 and bf16.
    The bf16-weight paths (phases 8, 9) at gemma3-27b's: bf16 q over f32
    K/V (bf16 weights over the Engine's f32 cache) in decode over wrapped
    1024-slot rings and the 2048-slot global cache, and in the 1500-token
    prefill under window 1024; the prefill those paths launch, all bf16,
    at that length; and at qwen1.5-110b's (64 q / 8 kv heads, head group
    8), bf16 q over its f32 Q_MAX_LEN cache.  Returns the ``kernels``
    entries (headline rows: the head-dim-256 decode and the mixed ring
    decode), every row in ``shapes``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    def case(B, S, H, K, D, qp_np, kp_np, qdt, kvdt):
        T = kp_np.shape[1]
        q = torch.randn((B, S, H, D), device=dev, generator=gen).to(qdt)
        k = torch.randn((B, T, K, D), device=dev, generator=gen).to(kvdt)
        v = torch.randn((B, T, K, D), device=dev, generator=gen).to(kvdt)
        return (q, k, v, torch.from_numpy(qp_np).to(dev),
                torch.from_numpy(kp_np).to(dev))

    f32, bf16 = torch.float32, torch.bfloat16
    g7 = get_config("gemma-7b")
    H, K, D = g7.n_heads, g7.n_kv_heads, g7.head_dim
    wide = {}
    ends = np.array(D7_PROMPTS) + D7_MAX_NEW - 1
    kp_np = np.full((len(ends), D7_MAX_LEN), 2**30, np.int32)
    for b, n in enumerate(ends):
        kp_np[b, :n + 1] = np.arange(n + 1)
    qp_np = ends[:, None].astype(np.int32)
    wide["decode"] = attention_row(
        "gemma-7b decode", *case(len(ends), 1, H, K, D, qp_np, kp_np, f32,
                                 f32), 0, flush, tag)
    for n in (max(D7_PROMPTS), min(D7_PROMPTS)):
        bucket = min(max(16, 1 << (n - 1).bit_length()), D7_MAX_LEN)
        pos = np.full((1, bucket), 2**30, np.int32)
        pos[0, :n] = np.arange(n)               # the Engine's padded bucket
        for dt in (f32, bf16):
            wide[f"prefill_{bucket}_{str(dt)[6:]}"] = attention_row(
                f"gemma-7b prefill bucket {bucket} ({n} tokens)",
                *case(1, bucket, H, K, D, pos, pos, dt, dt), 0, flush, tag)

    g3 = get_config("gemma3-27b")
    H, K, D, W = g3.n_heads, g3.n_kv_heads, g3.head_dim, g3.window
    ends = np.array(G_PROMPTS) + G_MAX_NEW - 1
    ring = np.full((len(ends), W), 2**30, np.int32)
    glob = np.full((len(ends), G_MAX_LEN), 2**30, np.int32)
    for b, n in enumerate(ends):
        t = np.arange(max(0, n - W + 1), n + 1)
        ring[b, t % W] = t
        glob[b, :n + 1] = np.arange(n + 1)
    qp_np = ends[:, None].astype(np.int32)
    P = max(G_PROMPTS)
    pre = np.arange(P, dtype=np.int32)[None]
    mixed = {
        "decode_ring": attention_row(
            "gemma3 mixed decode_ring",
            *case(len(ends), 1, H, K, D, qp_np, ring, bf16, f32), W, flush,
            tag),
        "decode_global": attention_row(
            "gemma3 mixed decode_global",
            *case(len(ends), 1, H, K, D, qp_np, glob, bf16, f32), 0, flush,
            tag),
        "prefill_local": attention_row(
            "gemma3 mixed prefill_local",
            *case(1, P, H, K, D, pre, pre, bf16, f32), W, flush, tag),
        "prefill_local_bf16": attention_row(
            "gemma3 bf16 prefill_local",
            *case(1, P, H, K, D, pre, pre, bf16, bf16), W, flush, tag)}
    qw = get_config("qwen1.5-110b")
    ends = np.array(Q_PROMPTS) + Q_MAX_NEW - 1
    kp_np = np.full((len(ends), Q_MAX_LEN), 2**30, np.int32)
    for b, n in enumerate(ends):
        kp_np[b, :n + 1] = np.arange(n + 1)
    mixed["qwen_decode"] = attention_row(
        "qwen1.5 mixed decode",
        *case(len(ends), 1, qw.n_heads, qw.n_kv_heads, qw.head_dim,
              ends[:, None].astype(np.int32), kp_np, bf16, f32), 0, flush,
        tag)
    out = []
    for head, rows in ((wide["decode"], wide), (mixed["decode_ring"], mixed)):
        row = dict(head)
        row["max_abs_err"] = max(r["max_abs_err"] for r in rows.values()
                                 if r["dtypes"] == head["dtypes"])
        row["shapes"] = rows
        out.append(row)
    return out


def model_params(cfg, dtype, label, why) -> dict:
    """Random weights for ``cfg`` from a CUDA generator seeded with SEED, in
    ``dtype`` (the norms stay f32, as the reference's); prints their size
    and ``why`` the run has this depth."""
    import torch
    from repro_torch.models import lm

    t0 = time.perf_counter()
    params = lm.init_lm(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                        dtype=dtype, device="cuda")
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    n = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"{label}: {n} parameters, {nbytes / 1e9:.1f} GB "
          f"({str(dtype).removeprefix('torch.')} weights, f32 norms) in "
          f"{time.perf_counter() - t0:.1f} s; {cfg.n_layers} layers, stages "
          f"(reps, group size) {[(r, len(g)) for r, g in lm.stages_of(cfg)]}"
          f": {why}")
    return params


def serve_phase(label, cfg, params, prompts, tag, *, slots, max_len,
                n_sessions, max_new, first, sched_wl=None,
                profile=True) -> dict:
    """One model served through the Engine: every prompt decoded once
    uninterrupted, then again with a suspend and a resume wave of the two
    longest (one of gemma3's rolled at prefill, one crossing its window in
    decode): tokens must equal the uninterrupted run's, no resume may fail
    its checksums, the stats must add up, and each launch counter, reset
    just before the measured Engine, must equal what its stats call for.
    Prints its sizes, prefill and decode times, the waves' rates and a
    decode profile; with ``sched_wl`` also the Scheduler over a fresh
    Engine (every job completes, resumes equal the resume waves' widths,
    the counters add up, K4 is not launched).  Returns the launch counts of
    its runs, summed."""
    import torch
    from repro_torch import sched
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, Request

    dev = torch.device("cuda")
    kw = dict(slots=slots, max_len=max_len, n_sessions=n_sessions,
              device=dev)
    solo = Engine(cfg, params, **kw)
    solo_reqs = [Request(uid, p, max_new) for uid, p in enumerate(prompts)]
    for r in solo_reqs:
        solo.submit(r)
    while solo.active:
        solo.step()
    solo.resume_many([0, 1], 2)      # warm the resume path before timing it
    while solo.active:
        solo.step()
    del solo
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    eng = Engine(cfg, params, **kw)
    lengths = sorted({lm.cache_len(cfg, m, max_len)
                      for m in cfg.layer_kinds()})
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(eng.cache))
    store_bytes = sum(t.numel() * t.element_size() for t in
                      (eng.sessions.slow, eng.sessions.fast))
    print(f"{label} snapshot: {eng.snapshot_bytes} B = "
          f"{eng.page_spec.n_pages} pages; cache lengths {lengths}; live "
          f"cache {cache_bytes / 1e9:.2f} GB ({slots} slots, max_len "
          f"{max_len}), session store {store_bytes / 1e9:.2f} GB "
          f"({n_sessions} sessions and the fast tier); card memory "
          f"allocated {torch.cuda.memory_allocated() / 1e9:.1f} GB")
    reqs = [Request(uid, p, max_new) for uid, p in enumerate(prompts)]
    prefill_ms = {}
    for r in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.submit(r)                        # ends in the next-token read
        prefill_ms[len(r.prompt)] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(first):
        eng.step()
    decode_s = time.perf_counter() - t0
    wave = sorted(eng.active, key=lambda s: len(eng.active[s].prompt))[-2:]
    held = {s: eng.active[s] for s in wave}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.suspend_many(wave)
    torch.cuda.synchronize()
    suspend_s = time.perf_counter() - t0
    uids = [held[s].uid for s in wave]
    extra = [max_new - len(held[s].generated) + 1 for s in wave]
    t0 = time.perf_counter()
    slots_back = eng.resume_many(uids, extra)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    resumed = {eng.active[s].uid: eng.active[s] for s in slots_back}
    while eng.active:
        eng.step()
    counts = ops.launch_counts()

    for r, s in zip(reqs, solo_reqs):
        got = (r.generated + resumed[r.uid].generated[1:]
               if r.uid in resumed else r.generated)
        check(len(s.generated) == max_new and got == s.generated,
              f"{label} uid {r.uid}: tokens differ from the uninterrupted "
              f"run")
    check(eng.verify_failure_count() == 0,
          f"{label}: a resume failed its checksums")
    check(int(eng.verify_store()) == 0, f"{label}: the store fails its scrub")
    st = eng.stats
    n_susp, n_res = len(wave) + len(reqs), len(wave)
    check(st["prefills"] == len(reqs) and st["suspends"] == n_susp
          and st["resumes"] == n_res, f"{label} stats counts: {st}")
    check(st["decoded_tokens"] == len(reqs) * (max_new - 1),
          f"{label} decoded_tokens {st['decoded_tokens']}")
    check(st["decode_dispatches"] == st["host_transfers"], "one read a step")
    want = (n_susp * eng.plan_suspend.cost.ns_lisa
            + n_res * eng.plan_resume.cost.ns_lisa)
    check(math.isclose(st["modeled_move_ns_lisa"], want, rel_tol=1e-9),
          f"{label}: modeled movement does not add up")
    check_counts(counts, serving_launches(cfg, st), f"{label}'s Engine path")
    print(f"{label} serving: tokens match the uninterrupted run for all "
          f"{len(reqs)} requests ({len(wave)} suspended+resumed); launches "
          f"{json.dumps(counts)}; stats {json.dumps(st)}")
    snap = eng.snapshot_bytes
    print(f"{label} decode: {first} steps x {slots} slots, "
          f"{decode_s / first * 1e3:.3f} ms/step, "
          f"{first * slots / decode_s:.1f} tok/s [{tag}]")
    for n, ms in prefill_ms.items():
        print(f"{label} prefill {n} tokens: {ms:.3f} ms [{tag}]")
    print(f"{label} suspend wave of {len(wave)}: {suspend_s * 1e3:.3f} ms, "
          f"{len(wave) * snap / suspend_s / 1e9:.2f} GB/s [{tag}]")
    print(f"{label} resume wave of {len(wave)}: {resume_s * 1e3:.3f} ms, "
          f"{len(wave) * snap / resume_s / 1e9:.2f} GB/s [{tag}]")
    if profile:
        profile_decode(eng, tag, label=f"{label} profile")
    del eng
    torch.cuda.empty_cache()
    if sched_wl is None:
        return counts

    # the Scheduler over a fresh Engine
    arrivals = sched.generate_workload(sched_wl, seed=4,
                                       vocab_size=cfg.vocab_size)
    eng = Engine(cfg, params, slots=slots, max_len=max_len,
                 n_sessions=sched.n_sessions_for(sched_wl), device=dev)
    ops.reset_launch_counts()
    s = sched.Scheduler(eng, policy="cost_aware", arrivals=arrivals)
    t0 = time.perf_counter()
    summary = s.run()
    torch.cuda.synchronize()
    sched_s = time.perf_counter() - t0
    sched_counts = ops.launch_counts()
    st = eng.stats
    jobs = sched_wl.n_fresh + sched_wl.n_followups
    check(summary["jobs_completed"] == jobs
          and all(j.state == "done" for j in s.jobs()),
          f"{label} scheduler: not every job completed")
    check(st["resumes"] == sum(s.metrics.wave_widths("resume_wave")),
          f"{label} scheduler: resumes outside the resume waves")
    check(st["decode_dispatches"] == st["host_transfers"],
          f"{label} scheduler: not one host read per decode dispatch")
    check(eng.verify_failure_count() == 0,
          f"{label} scheduler: a resume failed its checksums")
    check_counts(sched_counts, serving_launches(cfg, st),
                 f"{label} scheduler")
    print(f"{label} scheduler: {summary['jobs_completed']} jobs, "
          f"{st['decoded_tokens']} tokens in {s.tick_count} ticks, "
          f"{sched_s:.3f} s, {st['decoded_tokens'] / sched_s:.1f} tok/s, "
          f"{st['prefills']} prefills, {st['suspends']} suspends, "
          f"{st['resumes']} resumes, launches {json.dumps(sched_counts)} "
          f"[{tag}]")
    del eng, s
    torch.cuda.empty_cache()
    return {name: counts[name] + sched_counts[name] for name in counts}


def _prompts(cfg, lens, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def gemma3_phase(tag) -> dict:
    """Phase 6: full-width gemma3-27b cut to G_LAYERS layers (f32) through
    the Engine (4 slots, max_len 2048, a suspend and a resume wave of ring
    caches) and the Scheduler (prompts on both sides of the window)."""
    import dataclasses

    import torch
    from repro_torch import sched
    from repro_torch.configs import get_config, param_count

    full = get_config("gemma3-27b")
    cfg = dataclasses.replace(full, n_layers=G_LAYERS)
    params = model_params(
        cfg, torch.float32, "gemma3-27b",
        f"{G_LAYERS} of {full.n_layers} layers: at full depth the f32 "
        f"weights ({4 * param_count(full) / 1e9:.0f} GB) do not fit in the "
        f"card's memory, and {G_LAYERS} layers run both stages (the 5:1 "
        f"local/global periods and the local tail)")
    wl = sched.WorkloadConfig(n_fresh=6, n_followups=12, arrival="bursty",
                              prompt_lens=G_SCHED_LENS, new_tokens=(8, 16))
    counts = serve_phase("gemma3", cfg, params,
                         _prompts(cfg, G_PROMPTS, SEED + 6), tag,
                         slots=G_SLOTS, max_len=G_MAX_LEN,
                         n_sessions=G_SESSIONS, max_new=G_MAX_NEW,
                         first=G_FIRST, sched_wl=wl)
    del params
    torch.cuda.empty_cache()
    return counts


def gemma7b_phase(tag) -> dict:
    """Phase 7: gemma-7b at full width and depth (28 layers, head dim 256,
    MHA, GeGLU, tied embeddings; f32, the reference's serving precision)
    through the Engine and the Scheduler: K3 at head dim 256 on both
    routes."""
    import torch
    from repro_torch import sched
    from repro_torch.configs import get_config

    cfg = get_config("gemma-7b")
    params = model_params(cfg, torch.float32, "gemma-7b",
                          "full depth: the f32 weights fit")
    wl = sched.WorkloadConfig(n_fresh=6, n_followups=12, arrival="bursty",
                              prompt_lens=D7_SCHED_LENS, new_tokens=(8, 16))
    counts = serve_phase("gemma-7b", cfg, params,
                         _prompts(cfg, D7_PROMPTS, SEED + 7), tag,
                         slots=D7_SLOTS, max_len=D7_MAX_LEN,
                         n_sessions=D7_SESSIONS, max_new=D7_MAX_NEW,
                         first=D7_FIRST, sched_wl=wl)
    del params
    torch.cuda.empty_cache()
    return counts


def gemma3_bf16_phase(tag) -> dict:
    """Phase 8: gemma3-27b at all 62 layers with bf16 weights over the
    Engine's f32 cache (the reference Engine's own cache dtype): prefill
    runs K3 in bf16, decode its bf16-q-over-f32-K/V route; the Engine's
    waves, then the Scheduler."""
    import torch
    from repro_torch import sched
    from repro_torch.configs import get_config

    cfg = get_config("gemma3-27b")
    params = model_params(cfg, torch.bfloat16, "gemma3-27b bf16",
                          "full depth: bf16 weights fit where f32 ones "
                          "(108 GB) do not")
    wl = sched.WorkloadConfig(n_fresh=G62_SESSIONS, n_followups=8,
                              arrival="bursty", prompt_lens=G_SCHED_LENS,
                              new_tokens=(8, 16))
    counts = serve_phase("gemma3-62L bf16", cfg, params,
                         _prompts(cfg, G_PROMPTS, SEED + 8), tag,
                         slots=G_SLOTS, max_len=G_MAX_LEN,
                         n_sessions=G62_SESSIONS, max_new=G_MAX_NEW,
                         first=G_FIRST, sched_wl=wl)
    del params
    torch.cuda.empty_cache()
    return counts


def qwen_phase(tag) -> dict:
    """Phase 9: qwen1.5-110b (QKV bias, GQA 64/8, head dim 128) at full
    width with bf16 weights, cut to Q_LAYERS of its 80 layers: a short
    Engine run with one suspend and one resume wave."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, param_count

    full = get_config("qwen1.5-110b")
    cfg = dataclasses.replace(full, n_layers=Q_LAYERS)
    params = model_params(
        cfg, torch.bfloat16, "qwen1.5-110b bf16",
        f"{Q_LAYERS} of {full.n_layers} layers: all {full.n_layers} in "
        f"bf16 are {2 * param_count(full) / 1e9:.0f} GB, past the card's "
        f"80 GB; "
        f"every layer is alike (dense, QKV bias), so depth adds no path")
    counts = serve_phase("qwen1.5", cfg, params,
                         _prompts(cfg, Q_PROMPTS, SEED + 9), tag,
                         slots=Q_SLOTS, max_len=Q_MAX_LEN,
                         n_sessions=Q_SESSIONS, max_new=Q_MAX_NEW,
                         first=Q_FIRST, profile=False)
    del params
    torch.cuda.empty_cache()
    return counts


def kernel_name(mangled: str) -> str:
    """The kernel part of a mangled entry name, its namespaces dropped:
    ``prefill_kernelIfLi128E`` is ``pf::prefill_kernel<float, 128>``,
    ``decode_split_kernelI13__nv_bfloat16Li64ELi4E`` the bf16 decode
    kernel at head_dim 64, head group 4."""
    s = mangled[3:] if mangled.startswith("_ZN") else mangled
    name = ""
    while (m := re.match(r"\d+", s)):
        n = int(m.group(0))
        name, s = s[m.end():m.end() + n], s[m.end() + n:]
    return re.sub(r"E(Ev|v|P).*$", "", name + s)


def bit_equal(a, b) -> bool:
    """Same shape and the same bytes (NaNs and signed zeros included)."""
    import torch
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def serving_launches(cfg, st) -> dict:
    """The launches a serving run's stats call for.  K3 runs once a layer
    per prefill (its prefill kernel: every prompt is longer than one token)
    and per decode dispatch (its decode kernel); a suspend writes the slow row and
    its fast copy (two K1), a resume reads the slow row and the fast slot
    (two K2) and may insert into the fast tier (K1), a demotion clones a
    row (one K2, one K1); K4 is not on the serving path."""
    return {"flash_attention": cfg.n_layers * (st["prefills"]
                                               + st["decode_dispatches"]),
            "flash_attention_prefill": cfg.n_layers * st["prefills"],
            "flash_attention_decode": cfg.n_layers * st["decode_dispatches"],
            "villa_scatter": 2 * st["suspends"] + st["resumes"]
            + st["demotions"],
            "villa_gather": 2 * st["resumes"] + st["demotions"]}


def check_counts(counts, due, path) -> None:
    """Each kernel launched exactly as often as ``due`` says (never, for a
    kernel ``due`` leaves out), and each kernel ``due`` names at least
    once."""
    for name, n in counts.items():
        want = due.get(name, 0)
        check(n == want, f"kernel {name}: {n} launches on {path}, {want} due")
    for name, want in due.items():
        check(want > 0, f"kernel {name} was not launched on {path}")


def serve_runs(tag):
    """Phase 5: ``repro_torch.launch.serve.run`` at full width, plain and
    with a forked prefix plus a trace.  Yields each run's launch counts."""
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    cfg = get_config("tinyllama-1.1b")
    argv = ["--arch", "tinyllama-1.1b", "--slots", str(SLOTS),
            "--max-len", str(SERVE_LEN),
            "--requests", "16", "--followups", "32", "--max-new", "32",
            "--bursty", "--seed", "4"]
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = str(Path(tmp) / "trace.json")
        for extra in ([], ["--fork-prefix", "24", "--trace-out",
                           trace_path]):
            ops.reset_launch_counts()
            out, s = serve.run(argv + extra)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            eng, st = s.eng, s.eng.stats
            name = "launcher" + (" fork+trace" if extra else "")
            check(out["jobs_completed"] == 16 + 32
                  and all(j.state == "done" for j in s.jobs()),
                  f"{name}: not every job completed")
            check(st["resumes"] == sum(s.metrics.wave_widths("resume_wave")),
                  f"{name}: resumes outside the resume waves")
            check(out["decode_dispatches"] == out["host_transfers"],
                  f"{name}: not one host read per decode dispatch")
            check(eng.verify_failure_count() == 0,
                  f"{name}: a resume failed its checksums")
            if extra:
                check(out["fork"]["forks"] == 16
                      and out["fork"]["prefills"] == 1,
                      f"{name}: fork block {out['fork']}")
                with open(trace_path) as f:
                    events = json.load(f)["traceEvents"]
                check(len(events) > 0 and all("ph" in e for e in events),
                      f"{name}: the trace is not Chrome trace JSON")
            check_counts(counts, serving_launches(cfg, st), name)
            print(f"{name}: {out['jobs_completed']} jobs, "
                  f"{out['tokens_per_s']} tok/s, {out['ticks']} ticks, "
                  f"{out['seconds']} s, p50 {out['p50_latency_ns']} ns, "
                  f"p99 {out['p99_latency_ns']} ns (virtual clock), "
                  f"launches {json.dumps(counts)} [{tag}]")
            yield counts


def profile_decode(eng, tag, steps=4, label="profile"):
    """Device time by kernel over a few decode steps of every slot
    (torch.profiler), and the device's busy share of the host window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # budget: the seed token, one warm step, the window, and one more, so
    # no request completes (and suspends) inside the window
    eng.resume_many(sorted(eng.session_pos)[:eng.slots], steps + 3)
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):   # kernels only, not aten ops
            continue
        dev_us = e.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    print(f"{label}: {steps} decode steps, host window {wall_ms:.3f} ms, "
          f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%), "
          f"{launches / steps:.0f} kernels/step [{tag}]")
    for ms, n, key in rows[:12]:
        print(f"  {label} kernel {ms / steps:.4f} ms/step, {n} launches: "
              f"{key[:80]}")
    while eng.active:
        eng.step()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
