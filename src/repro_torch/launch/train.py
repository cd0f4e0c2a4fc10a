# Port of src/repro/launch/train.py in torch.  The flags are the
# reference's plus ``--device`` (default cuda).  ``--data``/``--model``
# build the mesh: stacked on one device, or one rank a device under
# torchrun.  The last line of output is the reference's JSON.
"""Training launcher: local mesh, checkpoint/restart, deterministic data.

Crash-and-rerun resumes from the newest intact checkpoint with the data
pipeline replaying the exact token stream (stateless ``batch_at(step)``),
onto whatever mesh the rerun asks for (the elastic restore).  The step is
``make_train_step``'s at its default ``donate=True`` on both forms, as the
reference's launcher compiles it: the state is updated in place.

  # on the card: one device, then a 2 x 2 mesh stacked on it
  python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 20 \
      --batch 8 --seq 512
  python -m repro_torch.launch.train --arch tinyllama-1.1b --reduced \
      --data 2 --model 2
  # across cards: one rank a card (WORLD_SIZE = data x model)
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch tinyllama-1.1b --reduced --data 2 --model 2
  # on the CPU, at the reduced width
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch tinyllama-1.1b --reduced --steps 50 --batch 8 --seq 128 \
      --data 2 --model 2 --ckpt-dir /tmp/ck --ckpt-every 20
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_config, get_reduced
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import shardings as SH
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
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    mesh = _mesh(args.data, args.model, dev)
    pcfg = ParallelConfig(fsdp=args.data > 1,
                          grad_compress=args.grad_compress)
    ocfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                     total_steps=args.steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)

    state = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), pcfg,
        device=dev)
    if mesh is None:
        step_fn = make_train_step(cfg, pcfg, ocfg)
        save_kw = {}
    else:
        _, compile_step, state_shardings = make_train_step(cfg, mesh, pcfg,
                                                           ocfg)
        shardings = state_shardings(state)
        save_kw = {"shardings": shardings}
        step_fn = compile_step(state, batch_at(dcfg, 0, device=dev))
    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        if mesh is None:
            state = ckpt.restore(state, args.ckpt_dir, device=dev)
        else:
            state = ckpt.restore(state, args.ckpt_dir, shardings=shardings)
        start_step = int(state.step.reshape(-1)[0])
        print(f"[resume] from step {start_step}")
    elif mesh is not None:
        state = SH.shard(state, shardings)

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
            ckpt.save(state, args.ckpt_dir, step + 1, **save_kw)
    dt = time.time() - t0
    result = {"first_loss": losses[0] if losses else None,
              "last_loss": losses[-1] if losses else None,
              "steps": len(losses), "seconds": round(dt, 1)}
    print(json.dumps(result, allow_nan=False))
    return result, state, {"losses": losses, "grad_norms": gnorms,
                           "step_s": step_s}


def _mesh(data: int, model: int, dev: torch.device):
    """None for one device; a ranks mesh under torchrun (``WORLD_SIZE``
    set), else ``data x model`` devices stacked on ``dev``."""
    if "WORLD_SIZE" in os.environ:
        return Mesh.from_env(data, model, device=dev)
    if data * model == 1:
        return None
    return make_local_mesh(data, model, device=dev)


def main(argv=None) -> dict:
    return run(argv)[0]


if __name__ == "__main__":
    main()
