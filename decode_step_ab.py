"""Decode step time of two checkouts of the port, in alternating windows.

    python3 decode_step_ab.py A_DIR B_DIR [--arch tinyllama-1.1b]
                              [--pairs 10] [--steps 8]

Needs one CUDA card.  Starts one worker process per checkout; each imports
``repro_torch`` from its own ``src/`` (so each builds and runs its own
kernels) and holds an Engine at full width with random weights from a
seed, filled with requests that outlast the run:

- tinyllama-1.1b: 8 slots, max_len 1024, eight prompts of 16-300 tokens
  (the prompts of ``chip_smoke.py``'s phase 3);
- gemma3-27b: cut to 14 of its 62 layers (f32), 4 slots, max_len 2048,
  prompts of 96, 700, 1010 and 1500 tokens (phase 6's).

The workers then decode ``--steps`` steps of every slot in turn, one
window at a time, while the other waits: ``--pairs`` pairs, the first of
each pair alternating (A B, B A, A B, ...).  A window is host ms a step
around steps that each end in their token read, the card synchronised
before it.  Prints every window, each side's median, and in how many
pairs B was faster; the last line is that as one JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
SETUPS = {   # arch: (layers or None for all, slots, max_len, prompt lengths)
    "tinyllama-1.1b": (None, 8, 1024, None),
    "gemma3-27b": (14, 4, 2048, (96, 700, 1010, 1500)),
}


def worker(tree: str, arch: str, budget: int) -> None:
    """Serve windows read from stdin ("<steps>") on one Engine; answer each
    with its host ms a step."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, Request

    layers, slots, max_len, lens = SETUPS[arch]
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    dev = torch.device("cuda")
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    if lens is None:
        lens = [int(x) for x in
                np.random.default_rng(SEED).integers(16, 301, slots)]
    prompts = [np.random.default_rng(SEED + 1 + i).integers(
        0, cfg.vocab_size, n).astype(np.int32) for i, n in enumerate(lens)]
    eng = Engine(cfg, params, slots=slots, max_len=max_len, n_sessions=slots,
                 device=dev)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p, budget + 4))
    for _ in range(2):
        eng.step()
    print("AB ready", flush=True)
    for line in sys.stdin:
        steps = int(line)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()                       # each ends in its token read
        ms = (time.perf_counter() - t0) / steps * 1e3
        if len(eng.active) != slots:
            raise RuntimeError("a request completed inside a window")
        print(f"AB {ms!r}", flush=True)


def answer(proc) -> str:
    """The worker's next "AB ..." line, its other output passed through."""
    for line in proc.stdout:
        if line.startswith("AB "):
            return line[3:].strip()
        print(line, end="")
    raise RuntimeError("a worker exited")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=SETUPS)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--budget", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.a, args.arch, args.budget)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("decode_step_ab.py needs a CUDA card", file=sys.stderr)
        return 1
    budget = args.pairs * args.steps
    procs = {}
    try:
        for side, tree in (("A", args.a), ("B", args.b)):
            procs[side] = subprocess.Popen(
                [sys.executable, __file__, tree, tree, "--worker",
                 "--arch", args.arch, "--budget", str(budget)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            if answer(procs[side]) != "ready":
                raise RuntimeError(f"worker {side} ({tree}) did not start")

        def window(side):
            procs[side].stdin.write(f"{args.steps}\n")
            procs[side].stdin.flush()
            return float(answer(procs[side]))

        ms = {"A": [], "B": []}
        b_faster = 0
        for i in range(args.pairs):
            order = ("A", "B") if i % 2 == 0 else ("B", "A")
            got = {side: window(side) for side in order}
            for side in order:
                ms[side].append(got[side])
            b_faster += got["B"] < got["A"]
            print(f"pair {i}: A {got['A']:.3f} ms, B {got['B']:.3f} ms a "
                  f"step ({order[0]} first)", flush=True)
    finally:
        for p in procs.values():
            if p.stdin:
                p.stdin.close()
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs.values()):
        print("a worker failed", file=sys.stderr)
        return 1
    out = {"arch": args.arch, "steps": args.steps, "pairs": args.pairs,
           "a": args.a, "b": args.b,
           "a_median_ms": statistics.median(ms["A"]),
           "b_median_ms": statistics.median(ms["B"]),
           "b_faster_pairs": b_faster, "a_ms": ms["A"], "b_ms": ms["B"]}
    print(f"{args.arch}: median ms a step A {out['a_median_ms']:.3f}, B "
          f"{out['b_median_ms']:.3f}; B faster in {b_faster} of "
          f"{args.pairs} pairs")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
