# Port of src/repro/__init__.py: the PyTorch/CUDA package.  It imports torch
# and numpy only — never jax, never the reference package.
"""repro_torch — the LISA serving system on PyTorch and CUDA.

The reference JAX package (``repro``) stays the specification; this package
mirrors its module paths (``repro/x/y.py`` is ported as ``repro_torch/x/y.py``)
and runs its hot path through hand-written Hopper kernels
(``repro_torch/kernels/csrc``).  Every entry point runs on ``cuda`` unless the
caller passes ``device="cpu"``; without a GPU and without an explicit device
it raises instead of falling back to the CPU.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else
    ``cuda``.  Raises when no GPU is present and the caller named no
    device — the CPU is only ever used on request."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU explicitly")
    return torch.device("cuda")


def to_device(x, device, dtype=None) -> torch.Tensor:
    """Host data (a sequence, numpy array or CPU tensor) as a tensor on
    ``device``.  A copy to the card goes through pinned memory without
    blocking, so the host never waits for work queued before it — a plain
    pageable copy would synchronise the stream."""
    t = torch.as_tensor(x, dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
