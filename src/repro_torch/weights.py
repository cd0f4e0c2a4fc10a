"""Parameters from the reference: ``params_from_jax``.

The reference's ``lm.init_lm`` draws its weights with ``jax.random``, which
torch cannot reproduce, so parity runs hand the reference's parameter tree
across as numpy arrays (``jax.tree.map(np.asarray, params)``, done by the
caller — this module imports neither jax nor the reference).  The port keeps
the same nested keys and the same stacked ``(reps, ...)`` layout, so the
conversion is leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device


def _tensor(x) -> torch.Tensor:
    """One leaf as a CPU tensor.  numpy has no bfloat16 of its own: the
    reference's bf16 leaves arrive in the ``bfloat16`` dtype of the
    ``ml_dtypes`` package, which torch cannot read, so their bytes are read
    as uint16 and viewed as ``torch.bfloat16``, bit for bit (found by its
    name: this module does not import ``ml_dtypes``)."""
    a = np.array(x, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(np_tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The reference's ``init_lm`` output, as numpy arrays, becomes the
    port's params on ``device`` (default: cuda, raising without a GPU)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _tensor(x).to(dev)

    return conv(np_tree)
