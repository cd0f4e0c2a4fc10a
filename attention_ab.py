"""K3's and K2's device time in two checkouts of the port, in alternating
windows.

    python3 attention_ab.py A_DIR B_DIR [--pairs 4]

Needs one CUDA card.  The shapes (:func:`shapes`) are those whose device ms
``chip_smoke.py``'s phase 2 keeps in PERF.md, built from its constants and
the port's configs: tinyllama's decode and prefill buckets, gemma3's
(and its f32 bucket 128, local and global), gemma-7b's, deepseek-v2's MLA
(bf16 and f32), olmoe's f32 buckets 1024 and 64, jamba's and qwen2-vl's
prefills, and the published head shapes of phase 26 (bf16 and f32); and
K2's three rows: the paging gather
of phase 2 (45,144 pages of 1 KiB, every entry live), and phase 20's
hops over 8 stacked shards of 549,978,112 B, the shift (every shard
moves, through ``StackedAxis.ppermute``, its table built in the window)
and the one-pair hop (K2 alone into a zeroed stack), each at its own
checkout's hop rows (``launch/mesh.py::hop_rows``).  Starts one worker
process per checkout; each imports that checkout's ``chip_smoke`` (and so
its own ``repro_torch``, which builds and runs its own kernels) and draws
the same inputs from a seed.  K3e's two rows, at phase 2's training
shape (tinyllama's heads, B T_BATCH x S T_SEQ, f32): forward plus backward
under autograd, and the backward alone (the gradients of one recorded
output, its graph kept), whatever backward each checkout runs.  Last,
phase 19 (b)'s uninterrupted training run (full-width tinyllama-1.1b
f32 through ``launch.train.run`` with chip_smoke's argv): a window is one
run in a process of its own, started for it in that checkout, its median
host ms a step over steps 2 on, printed with the run's peak memory (GiB,
the process's own: nothing else is on the card).  The workers time each
shape in turn,
one window at a time while the other waits: ``--pairs`` pairs a shape,
the first of each pair alternating (A B, B A, ...).  A window is
chip_smoke's ``timed(device=True)`` of 20 calls after an L2 flush; then
each side's host us to queue a call of a K3 shape (chip_smoke's
``enqueue_us``), A first.  A shape a checkout refuses (its wrapper raises
``ValueError``) times as NaN there.  Prints each shape's windows, each
side's median and B over A, and the host us; the last line is that as
one JSON object.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# K2's rows: tinyllama's snapshot at MAX_LEN (phase 2's paging gather), and
# phase 20's stack of one eighth of tinyllama's f32 weights a shard
K2_PAGES, K2_SHARDS, K2_SHARD_BYTES = 45_144, 8, 549_978_112


def shapes() -> dict:
    """``{name: (B, S, T, H, K, Dk, Dv, window, q dtype, k/v dtype)}`` of
    phase 2's attention rows, from chip_smoke's constants, and K2's rows
    (``{name: ("paging", pages)}`` or ``(kind, shards, shard bytes)``)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config

    def bucket(n, cap):
        return min(max(16, 1 << (n - 1).bit_length()), cap)

    tl, g3, g7, om = (get_config(a) for a in (
        "tinyllama-1.1b", "gemma3-27b", "gemma-7b", "olmoe-1b-7b"))
    ds, jb, vl = (get_config(a) for a in ("deepseek-v2-236b",
                                          "jamba-v0.1-52b", "qwen2-vl-72b"))
    out = {f"tinyllama_decode_{cs.SLOTS}x{cs.MAX_LEN}": (
        cs.SLOTS, 1, cs.MAX_LEN, tl.n_heads, tl.n_kv_heads, tl.head_dim,
        tl.head_dim, 0, "f32", "f32")}
    for b in cs.PREFILL_BUCKETS:
        out[f"tinyllama_prefill_{b}"] = (1, b, b, tl.n_heads, tl.n_kv_heads,
                                         tl.head_dim, tl.head_dim, 0, "f32",
                                         "f32")
    P, W = max(cs.G_PROMPTS), g3.window
    g3h = (g3.n_heads, g3.n_kv_heads, g3.head_dim, g3.head_dim)
    out[f"gemma3_prefill_{P}_w{W}"] = (1, P, P, *g3h, W, "f32", "f32")
    out[f"gemma3_prefill_{P}_w{W}_bf16"] = (1, P, P, *g3h, W, "bf16", "bf16")
    out["gemma3_decode_ring_bf16_q"] = (len(cs.G_PROMPTS), 1, W, *g3h, W,
                                        "bf16", "f32")
    b = bucket(min(cs.G_PROMPTS), cs.G_MAX_LEN)
    for w in (W, 0):
        out[f"gemma3_prefill_{b}_w{w}"] = (1, b, b, *g3h, w, "f32", "f32")
    for n in (max(cs.O_PROMPTS), cs.O_SHORT_PROMPT):
        b = bucket(n, cs.O_MAX_LEN)
        out[f"olmoe_prefill_{b}"] = (1, b, b, om.n_heads, om.n_kv_heads,
                                     om.head_dim, om.head_dim, 0, "f32",
                                     "f32")
    g7h = (g7.n_heads, g7.n_kv_heads, g7.head_dim, g7.head_dim)
    for n in (max(cs.D7_PROMPTS), min(cs.D7_PROMPTS)):
        b = bucket(n, cs.D7_MAX_LEN)
        for dt in ("f32", "bf16"):
            out[f"gemma7b_prefill_{b}_{dt}"] = (1, b, b, *g7h, 0, dt, dt)
    out[f"gemma7b_decode_{len(cs.D7_PROMPTS)}x{cs.D7_MAX_LEN}"] = (
        len(cs.D7_PROMPTS), 1, cs.D7_MAX_LEN, *g7h, 0, "f32", "f32")
    for b, _ in cs.MLA_BUCKETS:
        for dt in ("bf16", "f32"):
            out[f"mla_prefill_{b}_{dt}"] = (
                1, b, b, ds.n_heads, ds.n_heads,
                ds.qk_nope_dim + ds.qk_rope_dim, ds.v_head_dim, 0, dt, dt)
    P = max(cs.J_PROMPTS)
    out[f"jamba_prefill_{P}_bf16"] = (1, P, P, jb.n_heads, jb.n_kv_heads,
                                      jb.head_dim, jb.head_dim, 0, "bf16",
                                      "bf16")
    out[f"qwen2vl_prefill_{cs.V_IMG_LEN}_bf16"] = (
        1, cs.V_IMG_LEN, cs.V_IMG_LEN, vl.n_heads, vl.n_kv_heads,
        vl.head_dim, vl.head_dim, 0, "bf16", "bf16")
    for name, (H, K, D, W) in cs.HS_SHAPES.items():
        for dt in ("bf16", "f32"):
            out[f"{name}_prefill_{cs.HS_MAX_LEN}_{dt}"] = (
                1, cs.HS_MAX_LEN, cs.HS_MAX_LEN, H, K, D, D, W, dt, dt)
    for kind in ("train", "backward"):
        out[f"k3e_{kind}_{cs.T_BATCH}x{cs.T_SEQ}"] = (
            kind, cs.T_BATCH, cs.T_SEQ, tl.n_heads, tl.n_kv_heads,
            tl.head_dim)
    out[f"k2_paging_{K2_PAGES}x1KiB"] = ("paging", K2_PAGES)
    for kind in ("shift", "pair"):
        out[f"k2_{kind}_hop_{K2_SHARDS}x{K2_SHARD_BYTES}"] = (
            kind, K2_SHARDS, K2_SHARD_BYTES)
    out[f"train_phase19_{cs.T_BATCH}x{cs.T_SEQ}"] = (
        "train", cs.T_STEPS, cs.T_BATCH, cs.T_SEQ)
    return out


def worker(tree: str, table: dict) -> None:
    """Answer each stdin line "<shape> <reps>" with the median device ms
    of that many calls of K3 at the shape, in checkout ``tree``."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import _build, ops

    _build.build_all()
    dev = torch.device("cuda")
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    cases = {}
    for i, (name, spec) in enumerate(table.items()):
        g = torch.Generator(device=dev).manual_seed(cs.SEED + i)
        if name.startswith("k2_"):
            cases[name] = copy_case(spec, g, dev)
            continue
        if name.startswith("k3e_"):
            cases[name] = train_case(spec, g, dev)
            continue
        if name.startswith("train_"):       # run by main in its own process
            continue
        B, S, T, H, K, dk, dv, w, qd, kd = spec
        q = torch.randn((B, S, H, dk), device=dev, generator=g).to(dts[qd])
        k = torch.randn((B, T, K, dk), device=dev, generator=g).to(dts[kd])
        v = torch.randn((B, T, K, dv), device=dev, generator=g).to(dts[kd])
        kp = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
        if S == 1:                   # ragged rows: row b holds T - 97 b keys
            kp = kp.clone()
            for b in range(B):
                kp[b, T - 97 * b:] = 2**30
            qp = (T - 1 - 97 * torch.arange(B, device=dev)).to(
                torch.int32)[:, None]
        else:
            qp = kp[:, T - S:].contiguous()
        cases[name] = (q, k, v, qp, kp.contiguous(), w)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    print("ready", flush=True)
    for line in sys.stdin:
        name, reps = line.split()
        if reps == "enqueue" and callable(cases[name]):
            print(cs.enqueue_us(cases[name]), flush=True)
            continue
        if reps == "enqueue":
            q, k, v, qp, kp, w = cases[name]
            try:
                print(cs.enqueue_us(lambda: ops.chunked_attention(
                    q, k, v, qp, kp, window=w)), flush=True)
            except ValueError:
                print(math.nan, flush=True)
            continue
        if name.startswith(("k2_", "k3e_")):
            call = cases[name]
            print(cs.timed(call, int(reps), lambda: scratch.fill_(1),
                           device=True), flush=True)
            continue
        q, k, v, qp, kp, w = cases[name]

        def call():
            ops.chunked_attention(q, k, v, qp, kp, window=w)
        try:
            call()
        except ValueError:
            print(math.nan, flush=True)
            continue
        print(cs.timed(call, int(reps), lambda: scratch.fill_(1),
                       device=True), flush=True)


def train_run(tree: str) -> None:
    """Phase 19 (b)'s uninterrupted run in checkout ``tree``, in this
    process: prints the median host ms a step over steps 2 on and the
    peak GiB."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import chip_smoke as cs
    import torch
    from repro_torch.launch import train as launch_train

    argv = ["--arch", "tinyllama-1.1b", "--steps", str(cs.T_STEPS), "--lr",
            str(cs.T_LR), "--batch", str(cs.T_BATCH), "--seq",
            str(cs.T_SEQ), "--seed", str(cs.SEED), "--log-every", "5"]
    with contextlib.redirect_stdout(sys.stderr):    # stdout answers the parent
        _, _, hist = launch_train.run(argv)
    print(statistics.median(hist["step_s"][1:]) * 1e3,
          torch.cuda.max_memory_allocated() / 2**30, flush=True)


def train_case(spec, g, dev):
    """A K3e row's call in this worker's checkout: forward plus backward
    under autograd (``train``), or the backward alone, the gradients of one
    recorded output with its graph kept (``backward``)."""
    import torch
    from repro_torch.kernels import ops

    kind, B, S, H, K, D = spec
    leaves = [torch.randn(shape, device=dev, generator=g).requires_grad_()
              for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D))]
    up = torch.randn((B, S, H, D), device=dev, generator=g)
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    pos = pos.contiguous()
    if kind == "train":
        return lambda: torch.autograd.grad(
            ops.chunked_attention(*leaves, pos, pos), leaves, up)
    out = ops.chunked_attention(*leaves, pos, pos)
    return lambda: torch.autograd.grad(out, leaves, up, retain_graph=True)


def copy_case(spec, g, dev):
    """A K2 row's call in this worker's checkout: the paging gather of a
    random permutation of ``pages`` pages out of 32 sessions' pool, or a
    hop over ``n`` stacked shards at this checkout's hop rows."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import StackedAxis, hop_rows, hop_table

    if spec[0] == "paging":
        n = spec[1]
        pool = torch.randint(0, 256, (32 * n, 8, 128), dtype=torch.uint8,
                             device=dev, generator=g)
        table = torch.randperm(32 * n, device=dev, generator=g)[:n].to(
            torch.int32)
        return lambda: ops.villa_gather(pool, table)
    kind, n, shard = spec
    x = torch.randint(0, 256, (n, shard), dtype=torch.uint8, device=dev,
                      generator=g)
    if kind == "shift":
        ax = StackedAxis(n, device=dev)
        pairs = [(i, (i + 1) % n) for i in range(n)]
        return lambda: ax.ppermute(x, pairs)
    rows = x.view(-1, hop_rows(shard))
    per = rows.shape[0] // n
    pair = hop_table([-1, -1, -1, 2] + [-1] * (n - 4), per, dev)
    out = torch.zeros_like(rows)
    return lambda: ops.villa_gather(rows, pair, out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--pairs", type=int, default=4)
    p.add_argument("--worker", help=argparse.SUPPRESS)
    p.add_argument("--train", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        worker(args.a, json.loads(args.worker))
        return 0
    if args.train:
        train_run(args.a)
        return 0
    table = shapes()
    procs = {}
    for side, tree in (("A", args.a), ("B", args.b)):
        procs[side] = subprocess.Popen(
            [sys.executable, __file__, tree, tree, "--worker",
             json.dumps(table)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    for side, proc in procs.items():
        if proc.stdout.readline().strip() != "ready":
            raise RuntimeError(f"worker {side} did not start")

    peaks = {"A": [], "B": []}

    def window(side, name):
        if name.startswith("train_"):        # a run of its own: ms, peak GiB
            tree = args.a if side == "A" else args.b
            ms, peak = subprocess.run(
                [sys.executable, __file__, tree, tree, "--train"],
                stdout=subprocess.PIPE, text=True,
                check=True).stdout.split()[-2:]
            peaks[side].append(float(peak))
            return float(ms)
        proc = procs[side]
        proc.stdin.write(f"{name} 20\n")
        proc.stdin.flush()
        return float(proc.stdout.readline())

    out = {}
    try:
        for name in table:
            got = {"A": [], "B": []}
            for i in range(args.pairs):
                for side in (("A", "B") if i % 2 == 0 else ("B", "A")):
                    got[side].append(window(side, name))
            a, b = (statistics.median(got[s]) for s in ("A", "B"))
            out[name] = {"a_ms": a, "b_ms": b, "b_over_a": b / a,
                         "a_windows": got["A"], "b_windows": got["B"]}
            host = ""
            if name.startswith("train_"):
                for side in ("A", "B"):
                    out[name][f"{side.lower()}_peak_gib"] = max(peaks[side])
                    peaks[side].clear()
                host = (f"; peak GiB A {out[name]['a_peak_gib']:.2f}, B "
                        f"{out[name]['b_peak_gib']:.2f}")
            elif not name.startswith("k2_"):
                for side in ("A", "B"):
                    procs[side].stdin.write(f"{name} enqueue\n")
                    procs[side].stdin.flush()
                    out[name][f"{side.lower()}_enqueue_us"] = float(
                        procs[side].stdout.readline())
                host = (f"; host us a call A {out[name]['a_enqueue_us']:.1f},"
                        f" B {out[name]['b_enqueue_us']:.1f}")
            print(f"{name}: A {a:.4f} ms, B {b:.4f} ms, B/A {b / a:.4f} "
                  f"(A {got['A']}, B {got['B']}){host}", flush=True)
    finally:
        for proc in procs.values():
            proc.stdin.close()
            proc.wait(timeout=60)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
