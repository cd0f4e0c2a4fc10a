#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc`` with
nvcc (sm_90a), then:

  1. device   — requires CUDA; prints the card's name and power limit;
  2. kernels  — holds each kernel against its plain PyTorch version on the
                card at the shapes of phases 3, 5 and 6 (page gather/scatter
                and the tile copy bit-exact, attention within 3e-5 in f32
                and 2e-2 in bf16, at max_len 1024 and at the launcher's 256,
                and at gemma3's: a 1500-token prefill with window 1024 and
                without, decode over 1024-slot rings whose positions have
                wrapped and over the 2048-slot global cache), the tile copy
                also on odd shapes, dtypes and sizes, and times kernel,
                plain version and one library call for the same function;
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
  4. numbers  — serving and per-kernel times, each tagged with the card;
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
                launched).

The last line of standard output is ``{"ok": true, "device": {...}}``; any
failure exits non-zero before it.  Imports torch, numpy and repro_torch only.
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
SLOTS, MAX_LEN, N_SESSIONS, SEED = 8, 1024, 32, 0
SERVE_LEN = 256                  # the launcher's --max-len in phase 5
# phase 6: gemma3-27b at full width, cut to 14 layers (two 6-layer periods
# and the 2-layer local tail, so both stages run): 7.19 B f32 parameters,
# 28.8 GB, where all 62 layers (27.0 B, 108 GB) do not fit in 80 GB
G_LAYERS, G_SLOTS, G_MAX_LEN, G_SESSIONS = 14, 4, 2048, 16
G_PROMPTS, G_MAX_NEW, G_FIRST = (96, 700, 1010, 1500), 48, 24
G_SCHED_LENS = (300, 1100)       # the Scheduler run's prompt lengths


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


def timed(fn, reps=20, flush=None):
    """Median device ms of ``fn`` over ``reps`` calls (CUDA events), after
    warm-up; ``flush`` runs before each call, outside the timed window."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
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
    from repro_torch.models import lm
    from repro_torch.movement import paging
    from repro_torch.serve.engine import Engine, Request

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    tag = card()
    print(f"card: {tag}  torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name in sorted(built):
        log = (_build.BUILD_DIR / f"{name}.log").read_text()
        entry = ""
        for line in log.splitlines():
            m = re.search(r"entry function '([^']+)'", line)
            if m:
                entry = kernel_name(m.group(1))
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name} {entry}: {line.strip()}")

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
    idx = table.long()
    nbytes = 2 * n_pages * page + 4 * n_pages
    rows["villa_gather"] = dict(
        ms=timed(lambda: ops.villa_gather(pool, table), flush=flush),
        plain_ms=timed(lambda: ref.villa_gather_ref(pool, table), flush=flush),
        library_ms=timed(lambda: pool.index_select(0, idx), flush=flush),
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
    upd_s = upd[:spec_s.n_pages].contiguous()
    check(torch.equal(ops.villa_scatter(pool.clone(), rtab, upd_s),
                      ref.villa_scatter_ref(pool.clone(), rtab, upd_s)),
          f"villa_scatter differs at the max_len {SERVE_LEN} snapshot")
    print(f"villa_gather/villa_scatter: bit-exact at {n_pages} and "
          f"{spec_s.n_pages} pages")
    widx = wtab.long()
    rows["villa_scatter"] = dict(
        ms=timed(lambda: ops.villa_scatter(pool, wtab, upd), flush=flush),
        plain_ms=timed(lambda: ref.villa_scatter_ref(pool, wtab, upd),
                       flush=flush),
        library_ms=timed(lambda: pool.index_copy_(0, widx, upd),
                         flush=flush),
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

    def attn_err(case, tol):
        q, k, v, qp, kp, _ = case
        out = ops.chunked_attention(q, k, v, qp, kp)
        want = ref.chunked_attention_ref(q, k, v, qp, kp)
        err = float((out.float() - want.float()).abs().max())
        check(err <= tol, f"attention error {err} > {tol} at {tuple(q.shape)}"
                          f" x {tuple(k.shape)} {q.dtype}")
        return err, out

    errs = []
    for bucket in (16, 64, 256):
        case = attn_case(1, bucket, bucket, [int(rng.integers(bucket // 2 + 1,
                                                              bucket + 1))])
        errs.append(attn_err(case, 3e-5)[0])
        print(f"attention prefill bucket {bucket}: max_abs_err {errs[-1]:.3g}")
    # phase 5's shapes: the forked 24-token prefix prefills in bucket 32,
    # and decode attends over the launcher's max_len
    errs.append(attn_err(attn_case(1, 32, 32, [24]), 3e-5)[0])
    print(f"attention prefill bucket 32 (24 valid): max_abs_err "
          f"{errs[-1]:.3g}")
    slens = [int(x) for x in rng.integers(7, 57, SLOTS)]
    errs.append(attn_err(attn_case(SLOTS, 1, SERVE_LEN, slens,
                                   empty_row=True), 3e-5)[0])
    print(f"attention decode S=1 T={SERVE_LEN} B={SLOTS}: max_abs_err "
          f"{errs[-1]:.3g}")
    dlens = [int(x) for x in rng.integers(17, 333, SLOTS)]
    dec = attn_case(SLOTS, 1, MAX_LEN, dlens, empty_row=True)
    err, out = attn_err(dec, 3e-5)
    check(not out[0].any(), "a row with no valid key must give 0")
    errs.append(err)
    print(f"attention decode S=1 T={MAX_LEN} B={SLOTS}: max_abs_err {err:.3g}")
    bf = attn_case(2, 64, 64, [40, 64], dtype=torch.bfloat16)
    print(f"attention bf16 prefill 64: max_abs_err {attn_err(bf, 2e-2)[0]:.3g}")

    dec = attn_case(SLOTS, 1, MAX_LEN, dlens)
    q, k, v, qp, kp, _ = dec
    sdpa_mask = (kp[:, None, None, :] <= qp[:, None, :, None])
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = lambda: sdpa(qt, kt, vt, attn_mask=sdpa_mask,  # noqa: E731
                           enable_gqa=True)
    bound, by = attention_bound(q, k, qp, kp, 0)
    rows["flash_attention"] = dict(
        ms=timed(lambda: ops.chunked_attention(q, k, v, qp, kp), flush=flush),
        plain_ms=timed(lambda: ref.chunked_attention_ref(q, k, v, qp, kp),
                       flush=flush),
        library_ms=timed(library, flush=flush),
        bound_ms=bound, bound_by=by, max_abs_err=max(errs))
    for bucket in (16, 64, 256, 512):
        pq, pk, pv, pqp, pkp, _ = attn_case(1, bucket, bucket, [bucket])
        ms = timed(lambda: ops.chunked_attention(pq, pk, pv, pqp, pkp))
        print(f"attention prefill bucket {bucket} (full): kernel {ms:.4f} ms "
              f"[{tag}]")
    rows["flash_attention_window"] = window_attention_rows(dev, gen, flush,
                                                           tag)

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
        ms=timed(lambda: ops.rbm_copy(leaf), flush=flush),
        plain_ms=timed(lambda: ref.rbm_copy_ref(leaf), flush=flush),
        library_ms=timed(lambda: leaf.clone(), flush=flush),
        bound_ms=c_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        max_abs_err=copy_err)
    del scratch, leaf
    torch.cuda.synchronize()

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

    # ---- phase 5: scheduler-driven serving through the launcher ----------
    for run in serve_runs(tag):
        for name, n in run.items():
            counts[name] += n

    # ---- phase 6: gemma3-27b through the Engine and the Scheduler --------
    del params
    torch.cuda.empty_cache()
    g3 = gemma3_phase(tag)
    for name in ("villa_scatter", "villa_gather", "rbm_copy"):
        counts[name] += g3[name]
    counts["flash_attention_window"] = g3["flash_attention"]

    replaces = {
        "villa_scatter": "src/repro/kernels/rbm_copy.py:93",
        "villa_gather": "src/repro/kernels/rbm_copy.py:58",
        "flash_attention": "src/repro/kernels/flash_attention.py:81",
        "flash_attention_window": "src/repro/kernels/flash_attention.py:81",
        "rbm_copy": "src/repro/kernels/rbm_copy.py:27"}
    sources = {"villa_scatter": "src/repro_torch/kernels/csrc/page_copy.cu",
               "villa_gather": "src/repro_torch/kernels/csrc/page_copy.cu",
               "flash_attention":
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
               "flash_attention_window":
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
               "rbm_copy": "src/repro_torch/kernels/csrc/rbm_copy.cu"}
    # flash_attention counts K3 on the tinyllama paths (phases 3 and 5),
    # flash_attention_window the same kernel on gemma3's (phase 6)
    kernels = []
    for name in ("villa_scatter", "villa_gather", "flash_attention",
                 "flash_attention_window", "rbm_copy"):
        r = rows[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": sources[name], "replaces": replaces[name],
                        "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
        if "shapes" in r:
            kernels[-1]["shapes"] = r["shapes"]
        print(f"kernel {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), launches "
              f"{counts[name]} [{tag}]")
    print(json.dumps({"kernels": kernels}))
    print(tag)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def attention_bound(q, k, q_pos, kv_pos, window):
    """(ms, "bytes" or "operations") of the least time the card could take
    for this attention: q read and the output written once, positions read
    once, the K/V rows that some query of their batch row attends read
    once; 4*H*D FLOP per valid (query, key) pair, at the f32 peak."""
    qp, kp = q_pos.cpu().numpy(), kv_pos.cpu().numpy()
    valid = kp[:, None, :] <= qp[:, :, None]
    if window > 0:
        valid &= kp[:, None, :] > qp[:, :, None] - window
    B, S, H, D = q.shape
    K = k.shape[2]
    nbytes = (q.element_size() * (2 * q.numel()
                                  + 2 * int(valid.any(1).sum()) * K * D)
              + 4 * (qp.size + kp.size))
    flops = 4 * H * D * int(valid.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def window_attention_rows(dev, gen, flush, tag) -> dict:
    """Phase 2 at gemma3-27b's attention shapes (32 q / 16 kv heads, head
    dim 128, window 1024), which phase 6 launches: K3 against its plain
    version within 3e-5 in f32 and 2e-2 in bf16 for a 1500-token prefill
    (local, window 1024, and global), a ragged decode of 4 rows over 1024-
    slot rings whose positions have wrapped (slot t % 1024 holds token t),
    and over the 2048-slot global cache; each f32 shape timed beside its
    plain version, SDPA with the boolean (window) mask and its bound.
    Returns the ``kernels`` entry: the ring decode's numbers (12 of the 14
    layers launch it every decode step) and every shape's in ``shapes``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref

    cfg = get_config("gemma3-27b")
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
        errs = {}
        for dt, tol in ((torch.float32, 3e-5), (torch.bfloat16, 2e-2)):
            if dt == torch.bfloat16 and not bf16:
                continue
            args = (q.to(dt), k.to(dt), v.to(dt), qp, kp)
            got = ops.chunked_attention(*args, window=window)
            want = ref.chunked_attention_ref(*args, window=window)
            err = float((got.float() - want.float()).abs().max())
            check(err <= tol, f"attention {name} window {window} {dt}: "
                              f"error {err} > {tol}")
            errs[str(dt).removeprefix("torch.")] = err
        print(f"attention {name} S={S} T={T} B={nb} window {window}: "
              f"max_abs_err {errs}")
        if name == "decode_global_windowed":
            continue                  # a check only: no layer launches it
        mask = kp[:, None, None, :] <= qp[:, None, :, None]
        if window > 0:
            mask &= kp[:, None, None, :] > qp[:, None, :, None] - window
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        bound, by = attention_bound(q, k, qp, kp, window)
        out[name] = dict(
            ms=timed(lambda: ops.chunked_attention(q, k, v, qp, kp,
                                                   window=window),
                     flush=flush),
            plain_ms=timed(lambda: ref.chunked_attention_ref(
                q, k, v, qp, kp, window=window), flush=flush),
            library_ms=timed(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                          enable_gqa=True), flush=flush),
            bound_ms=bound, bound_by=by, max_abs_err=errs["float32"],
            max_abs_err_bf16=errs.get("bfloat16"))
        r = out[name]
        print(f"attention {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound "
              f"{bound:.5f} ms ({by}) [{tag}]")
    row = {k: v for k, v in out["decode_ring"].items()
           if k != "max_abs_err_bf16"}
    row["max_abs_err"] = max(r["max_abs_err"] for r in out.values())
    row["shapes"] = out
    return row


def gemma3_phase(tag) -> dict:
    """Phase 6: full-width gemma3-27b cut to G_LAYERS layers (f32, random
    weights from a CUDA generator) served through the Engine (a suspend and
    a resume wave of ring caches; tokens must equal an uninterrupted run)
    and through the Scheduler (prompts past the window).  Returns the
    launch counts of both runs, summed; each run's counts, reset just
    before it, must equal what its stats call for."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import sched
    from repro_torch.configs import get_config, param_count
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, Request

    dev = torch.device("cuda")
    full = get_config("gemma3-27b")
    cfg = dataclasses.replace(full, n_layers=G_LAYERS)
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"gemma3-27b: {n_params} f32 parameters ({4 * n_params / 1e9:.1f} "
          f"GB) in {time.perf_counter() - t0:.1f} s; {G_LAYERS} of "
          f"{full.n_layers} layers, stages (reps, group size) "
          f"{[(r, len(g)) for r, g in lm.stages_of(cfg)]}: at full "
          f"depth the f32 weights ({4 * param_count(full) / 1e9:.0f} GB) do "
          f"not fit in the card's memory, and {G_LAYERS} layers run both "
          f"stages (the 5:1 local/global periods and the local tail)")
    rng = np.random.default_rng(SEED + 6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in G_PROMPTS]
    kw = dict(slots=G_SLOTS, max_len=G_MAX_LEN, n_sessions=G_SESSIONS,
              device=dev)

    solo = Engine(cfg, params, **kw)
    solo_reqs = [Request(uid, p, G_MAX_NEW) for uid, p in enumerate(prompts)]
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
    lengths = sorted({lm.cache_len(cfg, m, G_MAX_LEN)
                      for m in cfg.layer_kinds()})
    print(f"gemma3 snapshot: {eng.snapshot_bytes} B = {eng.page_spec.n_pages}"
          f" pages; cache lengths {lengths}")
    reqs = [Request(uid, p, G_MAX_NEW) for uid, p in enumerate(prompts)]
    prefill_ms = {}
    for r in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.submit(r)                        # ends in the next-token read
        prefill_ms[len(r.prompt)] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(G_FIRST):
        eng.step()
    decode_s = time.perf_counter() - t0
    # the two longest prompts: one rolled at prefill, one crossing the
    # window in decode
    wave = sorted(eng.active, key=lambda s: len(eng.active[s].prompt))[-2:]
    held = {s: eng.active[s] for s in wave}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.suspend_many(wave)
    torch.cuda.synchronize()
    suspend_s = time.perf_counter() - t0
    uids = [held[s].uid for s in wave]
    extra = [G_MAX_NEW - len(held[s].generated) + 1 for s in wave]
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
        check(len(s.generated) == G_MAX_NEW and got == s.generated,
              f"gemma3 uid {r.uid}: tokens differ from the uninterrupted run")
    check(eng.verify_failure_count() == 0,
          "gemma3: a resume failed its checksums")
    check(int(eng.verify_store()) == 0, "gemma3: the store fails its scrub")
    st = eng.stats
    n_susp, n_res = len(wave) + len(reqs), len(wave)
    check(st["prefills"] == len(reqs) and st["suspends"] == n_susp
          and st["resumes"] == n_res, f"gemma3 stats counts: {st}")
    check(st["decoded_tokens"] == len(reqs) * (G_MAX_NEW - 1),
          f"gemma3 decoded_tokens {st['decoded_tokens']}")
    check(st["decode_dispatches"] == st["host_transfers"], "one read a step")
    want = (n_susp * eng.plan_suspend.cost.ns_lisa
            + n_res * eng.plan_resume.cost.ns_lisa)
    check(math.isclose(st["modeled_move_ns_lisa"], want, rel_tol=1e-9),
          "gemma3: modeled movement does not add up")
    check_counts(counts, serving_launches(cfg, st), "gemma3's Engine path")
    print(f"gemma3 serving: tokens match the uninterrupted run for all "
          f"{len(reqs)} requests ({len(wave)} suspended+resumed); launches "
          f"{json.dumps(counts)}; stats {json.dumps(st)}")
    snap = eng.snapshot_bytes
    print(f"gemma3 decode: {G_FIRST} steps x {G_SLOTS} slots, "
          f"{decode_s / G_FIRST * 1e3:.3f} ms/step, "
          f"{G_FIRST * G_SLOTS / decode_s:.1f} tok/s [{tag}]")
    for n, ms in prefill_ms.items():
        print(f"gemma3 prefill {n} tokens: {ms:.3f} ms [{tag}]")
    print(f"gemma3 suspend wave of {len(wave)}: {suspend_s * 1e3:.3f} ms, "
          f"{len(wave) * snap / suspend_s / 1e9:.2f} GB/s [{tag}]")
    print(f"gemma3 resume wave of {len(wave)}: {resume_s * 1e3:.3f} ms, "
          f"{len(wave) * snap / resume_s / 1e9:.2f} GB/s [{tag}]")
    profile_decode(eng, tag, label="gemma3 profile")
    del eng
    torch.cuda.empty_cache()

    # the Scheduler over a fresh Engine, prompts on both sides of the window
    wl = sched.WorkloadConfig(n_fresh=6, n_followups=12, arrival="bursty",
                              prompt_lens=G_SCHED_LENS, new_tokens=(8, 16))
    arrivals = sched.generate_workload(wl, seed=4, vocab_size=cfg.vocab_size)
    eng = Engine(cfg, params, slots=G_SLOTS, max_len=G_MAX_LEN,
                 n_sessions=sched.n_sessions_for(wl), device=dev)
    ops.reset_launch_counts()
    s = sched.Scheduler(eng, policy="cost_aware", arrivals=arrivals)
    t0 = time.perf_counter()
    summary = s.run()
    torch.cuda.synchronize()
    sched_s = time.perf_counter() - t0
    sched_counts = ops.launch_counts()
    st = eng.stats
    check(summary["jobs_completed"] == 18
          and all(j.state == "done" for j in s.jobs()),
          "gemma3 scheduler: not every job completed")
    check(st["resumes"] == sum(s.metrics.wave_widths("resume_wave")),
          "gemma3 scheduler: resumes outside the resume waves")
    check(st["decode_dispatches"] == st["host_transfers"],
          "gemma3 scheduler: not one host read per decode dispatch")
    check(eng.verify_failure_count() == 0,
          "gemma3 scheduler: a resume failed its checksums")
    check_counts(sched_counts, serving_launches(cfg, st), "gemma3 scheduler")
    print(f"gemma3 scheduler: {summary['jobs_completed']} jobs, "
          f"{st['decoded_tokens']} tokens in {s.tick_count} ticks, "
          f"{sched_s:.3f} s, {st['decoded_tokens'] / sched_s:.1f} tok/s, "
          f"{st['prefills']} prefills, {st['suspends']} suspends, "
          f"{st['resumes']} resumes, launches {json.dumps(sched_counts)} "
          f"[{tag}]")
    del eng, s, params
    torch.cuda.empty_cache()
    return {name: counts[name] + sched_counts[name] for name in counts}


def kernel_name(mangled: str) -> str:
    """The kernel part of a mangled entry name, its namespace dropped:
    ``attn_kernelIfLi128E`` is ``attn_kernel<float, 128>``,
    ``attn_kernelI13__nv_bfloat16Li64E`` the bf16 one at head_dim 64."""
    m = re.match(r"_ZN(\d+)", mangled)
    s = mangled[m.end() + int(m.group(1)):] if m else mangled
    return re.sub(r"E(Ev|v|P).*$", "", re.sub(r"^\d+", "", s))


def bit_equal(a, b) -> bool:
    """Same shape and the same bytes (NaNs and signed zeros included)."""
    import torch
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def serving_launches(cfg, st) -> dict:
    """The launches a serving run's stats call for.  K3 runs once a layer
    per prefill and per decode dispatch; a suspend writes the slow row and
    its fast copy (two K1), a resume reads the slow row and the fast slot
    (two K2) and may insert into the fast tier (K1), a demotion clones a
    row (one K2, one K1); K4 is not on the serving path."""
    return {"flash_attention": cfg.n_layers * (st["prefills"]
                                               + st["decode_dispatches"]),
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
    for ms, n, key in rows[:10]:
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
