# Port of src/repro/optim/adamw.py in torch: plain functions over the param
# tree (nested dicts of tensors), not ``torch.optim.AdamW``, whose schedule
# and decay rule differ.
"""AdamW with global-norm clipping and warmup+cosine schedule.

Moments are fp32 regardless of parameter dtype (bf16 training keeps fp32
optimizer state — the standard large-scale recipe); the update is computed in
fp32 and cast back, so bf16 parameters don't lose small updates to rounding
inside the moment math.  Every function returns new tensors and leaves its
inputs as they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    m: Dict
    v: Dict
    count: torch.Tensor


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` alike in
    structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves of nested dicts in the reference's order (keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def init(params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    leaf = tree_leaves(params)[0]
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    count=torch.zeros((), dtype=torch.int32,
                                      device=leaf.device))


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(g.to(torch.float32)))
              for g in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


def update(cfg: OptConfig, grads, state: OptState, params
           ) -> Tuple[Dict, OptState, Dict[str, torch.Tensor]]:
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    count = state.count + 1
    lr = schedule(cfg, count)
    b1c = 1 - cfg.beta1 ** count.to(torch.float32)
    b2c = 1 - cfg.beta2 ** count.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = cfg.beta1 * m + (1 - cfg.beta1) * g
        v = cfg.beta2 * v + (1 - cfg.beta2) * torch.square(g)
        step_ = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        decay = cfg.weight_decay if p.dim() >= 2 else 0.0
        p32 = p.to(torch.float32)
        newp = p32 - lr * (step_ + decay * p32)
        return newp.to(p.dtype), m, v

    flat = tree_map(upd, params, grads, state.m, state.v)
    pick = lambda i: tree_map(lambda t: t[i], flat)      # noqa: E731
    return pick(0), OptState(pick(1), pick(2), count), {
        "grad_norm": gnorm, "lr": lr}
