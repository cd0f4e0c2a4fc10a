# Port of src/repro/launch/train.py in torch, on one device.  The flags are
# the reference's plus ``--device`` (default cuda); ``--data``/``--model``
# above 1 need a mesh (ROADMAP item 16) and raise.  The last line of output
# is the reference's JSON.
"""Training launcher: checkpoint/restart, deterministic data, one device.

Crash-and-rerun resumes from the newest intact checkpoint with the data
pipeline replaying the exact token stream (stateless ``batch_at(step)``).

  # on the card
  python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 20 \
      --batch 8 --seq 512
  # on the CPU, at the reduced width
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch tinyllama-1.1b --reduced --steps 50 --batch 8 --seq 128 \
      --ckpt-dir /tmp/ck --ckpt-every 20
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_config, get_reduced
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.step import (ParallelConfig, TrainState,
                                    init_train_state, make_train_step)


def run(argv=None) -> Tuple[dict, TrainState, Dict[str, List[float]]]:
    """The launcher's run: ``(the JSON result, the final TrainState, every
    step's loss, grad norm and seconds on the host clock)``."""
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data", type=int, default=1)
    p.add_argument("--model", type=int, default=1)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--grad-compress", action="store_true")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="cpu or cuda (default: cuda, raising without a GPU)")
    args = p.parse_args(argv)
    if args.data > 1 or args.model > 1:
        raise NotImplementedError(
            f"--data {args.data} --model {args.model}: data and model "
            f"parallelism need a process group over several devices "
            f"(ROADMAP item 16); this launcher trains on one device")
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    pcfg = ParallelConfig(fsdp=False, grad_compress=args.grad_compress)
    ocfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                     total_steps=args.steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)

    state = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), pcfg,
        device=dev)
    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        state = ckpt.restore(state, args.ckpt_dir, device=dev)
        start_step = int(state.step)
        print(f"[resume] from step {start_step}")

    step_fn = make_train_step(cfg, pcfg, ocfg)
    losses, gnorms, step_s = [], [], []
    t0 = time.time()
    for step in range(start_step, args.steps):
        t_step = time.perf_counter()
        batch = batch_at(dcfg, step, device=dev)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        step_s.append(time.perf_counter() - t_step)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"ce {float(metrics['ce']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        if args.ckpt_dir and args.ckpt_every and \
                (step + 1) % args.ckpt_every == 0:
            ckpt.save(state, args.ckpt_dir, step + 1)
    dt = time.time() - t0
    result = {"first_loss": losses[0] if losses else None,
              "last_loss": losses[-1] if losses else None,
              "steps": len(losses), "seconds": round(dt, 1)}
    print(json.dumps(result, allow_nan=False))
    return result, state, {"losses": losses, "grad_norms": gnorms,
                           "step_s": step_s}


def main(argv=None) -> dict:
    return run(argv)[0]


if __name__ == "__main__":
    main()
