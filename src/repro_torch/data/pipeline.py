# Port of src/repro/data/pipeline.py in torch.  ``batch_at`` draws on a CPU
# generator seeded from (seed, step) and moves the batch to the device, so
# the stream is the same on the CPU and on the card; its numbers differ
# from the reference's (jax.random cannot be reproduced), the recipe is
# the same.
"""Deterministic synthetic LM data pipeline.

Stateless: ``batch_at(step)`` is a pure function of (seed, step), so restart
after a failure reproduces the exact token stream with no data-loader state
in the checkpoint — the fault-tolerance property the launcher relies on.

The synthetic language has learnable structure (a repeated-segment copy task
over a Markov backbone) so small models show clear loss decrease within a
few hundred steps — the end-to-end example trains on it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device, to_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    repeat_len: int = 16       # copy-task period (structure to learn)


def batch_at(cfg: DataConfig, step: int, device=None
             ) -> Dict[str, torch.Tensor]:
    """The global batch for ``step`` (tokens, labels: (B, S) int32) on
    ``device`` (default: cuda, raising without a GPU)."""
    dev = resolve_device(device)
    # the CPU generator keeps 32 bits of a seed: (seed, step) is hashed
    # into them
    g = torch.Generator().manual_seed(int(np.random.SeedSequence(
        [cfg.seed, int(step)]).generate_state(1)[0]))
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    R = min(cfg.repeat_len, S)
    n_rep = -(-S // R)
    base = torch.randint(0, V, (B, R), generator=g, dtype=torch.int32)
    tokens = base.repeat(1, n_rep)[:, :S]
    # sprinkle noise so it's not trivially memorisable
    noise = torch.rand((B, S), generator=g) < 0.05
    rand = torch.randint(0, V, (B, S), generator=g, dtype=torch.int32)
    tokens = torch.where(noise, rand, tokens)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    return {"tokens": to_device(tokens, dev),
            "labels": to_device(labels, dev)}


def host_shard(batch: Dict[str, torch.Tensor], host_id: int, n_hosts: int
               ) -> Dict[str, torch.Tensor]:
    """Slice the per-host shard of a global batch."""
    def cut(x):
        per = x.shape[0] // n_hosts
        return x[host_id * per:(host_id + 1) * per]
    return {k: cut(v) for k, v in batch.items()}
