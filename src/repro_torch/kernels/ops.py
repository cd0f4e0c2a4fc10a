# Port of src/repro/kernels/ops.py: the public kernel entry points.
"""Dispatch between the CUDA kernels and their plain versions.

The rule, for every entry point here: a CUDA tensor launches the kernel
(``kernels/rbm_copy.py``, ``kernels/flash_attention.py``), and if the launch
cannot happen the wrapper raises; a CPU tensor takes the plain version in
``kernels/ref.py``.  No ``try`` falls back from one to the other.  The
launch counters live on the CUDA wrappers (:func:`launch_counts`).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rbm_copy as RC
from repro_torch.kernels import ref

# the CUDA wrappers whose ``launches`` a run reads, by kernel name
KERNELS = {"villa_scatter": RC.villa_scatter,
           "villa_gather": RC.villa_gather,
           "flash_attention": FA.chunked_attention}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def villa_gather(pages: torch.Tensor, table, out=None) -> torch.Tensor:
    """out[j] = pages[table[j]] (K2); with ``out``, -1 entries keep out[j]."""
    if pages.is_cuda:
        return RC.villa_gather(pages, table, out)
    return ref.villa_gather_ref(pages, torch.as_tensor(table), out)


def villa_scatter(pages: torch.Tensor, table, updates) -> torch.Tensor:
    """pages[table[j]] = updates[j] in place (K1): -1 skips, last wins."""
    if pages.is_cuda:
        return RC.villa_scatter(pages, table, updates)
    return ref.villa_scatter_ref(pages, torch.as_tensor(table), updates)


def chunked_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                      window: int = 0, block: int = 512) -> torch.Tensor:
    """Attention in the serving layout (K3); ``block`` is the plain
    version's KV chunk (the kernel tiles on its own)."""
    if q.is_cuda:
        return FA.chunked_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                    window=window)
    return ref.chunked_attention_ref(q, k, v, q_pos, kv_pos, causal=causal,
                                     window=window, block=block)


flash_attention = FA.flash_attention
