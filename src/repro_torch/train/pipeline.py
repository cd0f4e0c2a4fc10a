# Port of src/repro/train/pipeline.py:30-107 in torch: gpipe and
# pipeline_transformer over a mesh axis object (repro_torch/launch/mesh.py)
# where the reference takes a Mesh and an axis name.
"""Pipeline parallelism over a mesh axis via LISA hop transfers (GPipe).

Stage-to-stage activation movement is a planned movement: a stage->stage
``movement.Transfer`` lowers to a single neighbor hop-chain leg (the
``ppermute`` shift = the RBM primitive, executed by the ``hop_chain``
backend over the axis the env names), exactly the paper's adjacent-
subarray path: stage s computes a microbatch, its output hops one link to
stage s+1 while stage s starts the next microbatch — the classic GPipe
schedule with n_stages + n_micro - 1 slots.

Every device holds its stage's parameters (stacked layer group); tensors
carry the axis's local devices on dim 0, as in
:mod:`repro_torch.core.lisa.rbm`.  The schedule's per-device conditions
(which microbatch a stage runs in a slot, whether it is active) come from
the axis's host positions, so a slot queues its kernels without waiting
for the device.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch import movement as MV
from repro_torch import to_device


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype ``Layout.dense`` prices a payload by; a raw one of
    the same width where numpy has none (bfloat16)."""
    try:
        return torch.empty(0, dtype=dtype).numpy().dtype
    except TypeError:
        return np.dtype(f"V{dtype.itemsize}")


def gpipe(stage_fn: Callable, axis):
    """Build a pipelined forward: ``stage_fn(params_stage, x) -> y``.

    Returns ``run(stage_params, micro_in) -> micro_out``:
      stage_params: this process's stages' params, local devices on dim 0;
      micro_in: (local, n_micro, mb, ...) microbatches, the same on every
                device; microbatch m enters stage 0 at slot m, exits stage
                S-1 at slot m + S - 1.
    Every device returns all the outputs (the closing ``psum``).
    """

    def run(stage_params, micro_in):
        n_stages = axis.size
        pos = axis.positions
        local, n_micro = micro_in.shape[:2]
        n_slots = n_stages + n_micro - 1
        dev = micro_in.device
        rows = torch.arange(local, device=dev)
        first = axis.mask([0]).view((-1,) + (1,) * (micro_in.dim() - 2))
        axes = {axis.name: axis}

        hop_plan = outputs = None
        carry_in = torch.zeros_like(micro_in[:, 0])
        for t in range(n_slots):
            m = [t - p for p in pos]          # microbatch at each stage
            clip = [min(max(v, 0), n_micro - 1) for v in m]
            mi = to_device(clip, dev, torch.int64)
            x = torch.where(first, micro_in[rows, mi], carry_in)
            y = stage_fn(stage_params, x)
            active = axis.mask([p for p, v in zip(pos, m)
                                if 0 <= v < n_micro])
            y = torch.where(active.view((-1,) + (1,) * (y.dim() - 1)), y,
                            torch.zeros((), dtype=y.dtype, device=dev))
            if hop_plan is None:
                # Stage-to-stage hop as a movement plan: one neighbor-shift
                # hop-chain leg, planned once per activation shape.
                hop_plan = MV.plan(MV.Transfer(
                    MV.Tier("stage", axis=axis.name),
                    MV.Tier("stage", axis=axis.name),
                    MV.Layout.dense(y.shape[1:], _numpy_dtype(y.dtype))))
                outputs = torch.zeros((local, n_micro) + tuple(y.shape[1:]),
                                      dtype=y.dtype, device=dev)
            # RBM hop: activations move one link toward the next stage
            carry_in = MV.execute(hop_plan, data=y, axes=axes)["data"]
            for i, (p, v) in enumerate(zip(pos, m)):
                if p == n_stages - 1 and 0 <= v < n_micro:
                    outputs[i, v] = y[i]
        # results live on the last stage; the sum hands them to every stage
        return axis.psum(outputs)

    return run


def pipeline_transformer(axis, layer_fn: Callable, n_layers_per_stage: int):
    """Convenience: stage = a loop over this stage's layer slice.

    ``pipelined(params_stacked, micro_in)``: params_stacked's leaves are
    (local, n_layers_per_stage, ...), this process's stages (all of them
    on a StackedAxis, its rank's on a GroupAxis); ``layer_fn(p, h)`` takes
    one layer's leaves (local, ...) and h (local, mb, ...).
    """

    def stage_fn(stage_params, x):
        h = x
        for i in range(n_layers_per_stage):
            h = layer_fn({k: a[:, i] for k, a in stage_params.items()}, h)
        return h

    return gpipe(stage_fn, axis)
