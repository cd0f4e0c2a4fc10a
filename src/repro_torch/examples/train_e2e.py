# Port of examples/train_e2e.py: the same ~100M-parameter llama-style
# config trained through the port's launcher, on the card unless
# ``--device cpu``; checkpoints go to a temporary directory.
"""End-to-end training run: trains a ~100M-parameter llama-family model
for a few hundred steps on the synthetic copy-task corpus, with periodic
checkpoints and crash-safe resume.

Pass --small for a CI-sized run (the assertions are the same).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_e2e [--small]
          [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile

from repro_torch import configs as C
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.train import main as train_main

# ~100M-parameter llama-style config (decoder-only, GQA, SwiGLU)
M100 = ModelConfig(
    name="llama-100m", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
    d_ff=2048, vocab_size=32000, activation="swiglu", remat=False,
    attn_block=256, scan_chunk=64)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda, raising without a GPU)")
    args = ap.parse_args(argv)

    cfg = M100
    if args.small:
        cfg = dataclasses.replace(M100, n_layers=4, d_model=256, n_heads=4,
                                  n_kv_heads=2, d_ff=688, vocab_size=2048)
    steps = args.steps or (60 if args.small else 300)
    # register so --arch finds it
    C._MODULES["llama-100m"] = type("M", (), {"CONFIG": cfg, "REDUCED": cfg})
    device = ["--device", args.device] if args.device else []
    with tempfile.TemporaryDirectory(prefix="lisa_e2e_ckpt") as ckpt_dir:
        res = train_main(["--arch", "llama-100m", "--steps", str(steps),
                          "--batch", "4", "--seq", "256", "--lr", "1e-3",
                          "--ckpt-dir", ckpt_dir, "--ckpt-every",
                          str(max(steps // 5, 1)), "--log-every", "10",
                          *device])
    assert res["last_loss"] < res["first_loss"], "training did not learn"
    print(f"OK: loss {res['first_loss']:.3f} -> {res['last_loss']:.3f} "
          f"over {res['steps']} steps ({res['seconds']}s)")
    return res


if __name__ == "__main__":
    main()
