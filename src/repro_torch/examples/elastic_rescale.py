# Port of examples/elastic_rescale.py: the same two phases in one process,
# each mesh stacked on one device (the reference spawns two processes of 8
# forced host devices), on the card unless ``--device cpu``.
"""Elastic rescaling (fault tolerance): checkpoint on one mesh, resume on a
different one.  The relayout is the bulk cross-device movement that the LISA
substrate accelerates (checkpoint restore -> each device's slices; on a
live cluster the same plan runs as lisa_copy hop chains).

Run:  PYTHONPATH=src python -m repro_torch.examples.elastic_rescale \
          [--device cpu]
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.train import shardings as SH
from repro_torch.train.step import (ParallelConfig, init_train_state,
                                    make_train_step)


def main(argv=None) -> dict:
    """Both phases; returns their losses and the resumed step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda, raising without a GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced("tinyllama-1.1b")
    pcfg = ParallelConfig(fsdp=True)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
    d = tempfile.mkdtemp()
    try:
        # phase 1: 8 devices, 4-way DP x 2 TP
        mesh = make_local_mesh(4, 2, device=dev)
        state = init_train_state(cfg, torch.Generator(device=dev)
                                 .manual_seed(0), pcfg, device=dev)
        _, compile_step, state_shardings = make_train_step(cfg, mesh, pcfg)
        sh = state_shardings(state)
        step = compile_step(state, batch_at(dcfg, 0, device=dev))
        state = SH.shard(state, sh)
        for i in range(3):
            state, m = step(state, batch_at(dcfg, i, device=dev))
        ckpt.save(state, d, 3, shardings=sh)
        loss1 = float(m["loss"])
        print("phase1 loss:", loss1)

        # phase 2: "lost" 4 devices: a 2 x 2 mesh
        mesh = make_local_mesh(2, 2, device=dev)
        template = init_train_state(cfg, torch.Generator(device=dev)
                                    .manual_seed(0), pcfg, device=dev)
        _, compile_step, state_shardings = make_train_step(cfg, mesh, pcfg)
        sh = state_shardings(template)
        state = ckpt.restore(template, d, shardings=sh)  # elastic relayout
        resumed = int(state.step[0])
        print("resumed at step", resumed, "on", mesh.devices.shape)
        b = batch_at(dcfg, 3, device=dev)
        state, m = compile_step(template, b)(state, b)
        loss2 = float(m["loss"])
        print("phase2 (rescaled) loss:", loss2)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print("elastic rescale OK: 4x2 -> 2x2 resume succeeded")
    return {"phase1_loss": loss1, "resumed_step": resumed,
            "phase2_loss": loss2}


if __name__ == "__main__":
    main()
