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
           "flash_attention": FA.chunked_attention,
           "rbm_copy": RC.rbm_copy}


# K3's launches by route: the tensor-core prefill kernel and the split-KV
# decode kernel, whose sum is ``flash_attention``
ROUTES = {"flash_attention_prefill": (FA.chunked_attention, "prefill"),
          "flash_attention_decode": (FA.chunked_attention, "decode"),
          # of the decode route, the launches over an int8 cache (K3d)
          "flash_attention_decode_int8": (FA.chunked_attention,
                                          "decode_int8")}


def launch_counts() -> Dict[str, int]:
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    counts.update({name: getattr(fn, route)
                   for name, (fn, route) in ROUTES.items()})
    return counts


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for fn, route in ROUTES.values():
        setattr(fn, route, 0)


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


def rbm_copy(x: torch.Tensor, *, tile_rows: int = 256,
             lanes: int = 128) -> torch.Tensor:
    """A copy of ``x`` through (tile_rows x lanes) tiles (K4)."""
    if x.is_cuda:
        return RC.rbm_copy(x, tile_rows=tile_rows, lanes=lanes)
    return ref.rbm_copy_ref(x, tile_rows=tile_rows, lanes=lanes)


def chunked_attention(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                      window: int = 0, block: int = 512, k_scale=None,
                      v_scale=None) -> torch.Tensor:
    """Attention in the serving layout (K3); ``block`` is the plain
    version's KV chunk (the kernel tiles on its own).  int8 K/V take their
    (B,T,K) f32 ``k_scale``/``v_scale``.  On the card, where grad is
    enabled and q, k or v requires it (training), K3e: the kernel's
    forward with a recomputed plain backward."""
    if q.is_cuda and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return FA.train_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                  window=window, block=block)
    if q.is_cuda:
        return FA.chunked_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                    window=window, k_scale=k_scale,
                                    v_scale=v_scale)
    return ref.chunked_attention_ref(q, k, v, q_pos, kv_pos, causal=causal,
                                     window=window, block=block,
                                     k_scale=k_scale, v_scale=v_scale)


flash_attention = FA.flash_attention
