#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc`` with
nvcc (sm_90a), then:

  1. device   — requires CUDA; prints the card's name and power limit;
  2. kernels  — holds each kernel against its plain PyTorch version on the
                card at the serving path's shapes (page gather/scatter
                bit-exact, attention within 3e-5 in f32) and times kernel,
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
  4. numbers  — serving and per-kernel times, each tagged with the card.

The last line of standard output is ``{"ok": true, "device": {...}}``; any
failure exits non-zero before it.  Imports torch, numpy and repro_torch only.
"""
from __future__ import annotations

import json
import math
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

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
    dlens = [int(x) for x in rng.integers(17, 333, SLOTS)]
    dec = attn_case(SLOTS, 1, MAX_LEN, dlens, empty_row=True)
    err, out = attn_err(dec, 3e-5)
    check(not out[0].any(), "a row with no valid key must give 0")
    errs.append(err)
    print(f"attention decode S=1 T={MAX_LEN} B={SLOTS}: max_abs_err {err:.3g}")
    bf = attn_case(2, 64, 64, [40, 64], dtype=torch.bfloat16)
    print(f"attention bf16 prefill 64: max_abs_err {attn_err(bf, 2e-2)[0]:.3g}")

    dec = attn_case(SLOTS, 1, MAX_LEN, dlens)
    q, k, v, qp, kp, lens = dec
    sdpa_mask = (kp[:, None, None, :] <= qp[:, None, :, None])
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = lambda: sdpa(qt, kt, vt, attn_mask=sdpa_mask,  # noqa: E731
                           enable_gqa=True)
    pairs = sum(lens)                            # valid (query, key) pairs
    a_bytes = 4 * (2 * q.numel() + qp.numel() + kp.numel()
                   + 2 * sum(n * K * D for n in lens))
    a_flops = 4 * H * D * pairs
    rows["flash_attention"] = dict(
        ms=timed(lambda: ops.chunked_attention(q, k, v, qp, kp), flush=flush),
        plain_ms=timed(lambda: ref.chunked_attention_ref(q, k, v, qp, kp),
                       flush=flush),
        library_ms=timed(library, flush=flush),
        bound_ms=max(a_bytes / HBM_BYTES_PER_S, a_flops / F32_FLOP_PER_S) * 1e3,
        bound_by=("bytes" if a_bytes / HBM_BYTES_PER_S
                  >= a_flops / F32_FLOP_PER_S else "operations"),
        max_abs_err=max(errs))
    for bucket in (16, 64, 256, 512):
        pq, pk, pv, pqp, pkp, _ = attn_case(1, bucket, bucket, [bucket])
        ms = timed(lambda: ops.chunked_attention(pq, pk, pv, pqp, pkp))
        print(f"attention prefill bucket {bucket} (full): kernel {ms:.4f} ms "
              f"[{tag}]")
    del scratch
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
    # K3 runs once a layer per prefill and per decode dispatch; a suspend
    # writes the slow row and its fast copy (two K1), a resume reads the slow
    # row and the fast slot (two K2) and may insert into the fast tier (K1),
    # a demotion clones a row (one K2, one K1)
    want_counts = {
        "flash_attention": cfg.n_layers * (st["prefills"]
                                           + st["decode_dispatches"]),
        "villa_scatter": 2 * st["suspends"] + st["resumes"] + st["demotions"],
        "villa_gather": 2 * st["resumes"] + st["demotions"]}
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the serving path")
        check(n == want_counts[name], f"kernel {name}: {n} launches on the "
                                      f"serving path, {want_counts[name]} due")
    print(f"serving: tokens match the uninterrupted run for all 8 requests "
          f"({len(wave)} suspended+resumed); stats {json.dumps(st)}")

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
    replaces = {
        "villa_scatter": "src/repro/kernels/rbm_copy.py:93",
        "villa_gather": "src/repro/kernels/rbm_copy.py:58",
        "flash_attention": "src/repro/kernels/flash_attention.py:81"}
    sources = {"villa_scatter": "src/repro_torch/kernels/csrc/page_copy.cu",
               "villa_gather": "src/repro_torch/kernels/csrc/page_copy.cu",
               "flash_attention":
                   "src/repro_torch/kernels/csrc/flash_attention.cu"}
    kernels = []
    for name in ("villa_scatter", "villa_gather", "flash_attention"):
        r = rows[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": sources[name], "replaces": replaces[name],
                        "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
        print(f"kernel {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), launches "
              f"{counts[name]} [{tag}]")
    profile_decode(eng, tag)
    print(json.dumps({"kernels": kernels}))
    print(tag)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile_decode(eng, tag, steps=4):
    """Device time by kernel over a few decode steps of all 8 sessions
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
    print(f"profile: {steps} decode steps, host window {wall_ms:.3f} ms, "
          f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%), "
          f"{launches / steps:.0f} kernels/step [{tag}]")
    for ms, n, key in rows[:10]:
        print(f"  profile kernel {ms / steps:.4f} ms/step, {n} launches: "
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
