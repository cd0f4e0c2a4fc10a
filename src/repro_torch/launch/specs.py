# Port of src/repro/launch/specs.py in torch: meta-device tensors in place
# of jax.ShapeDtypeStruct, built by the port's own constructors with every
# random draw sent to the meta device.
"""Meta-device stand-ins for every model input (no device allocation).

``input_specs`` covers the batch inputs; ``state_specs`` / ``cache_specs``
/ ``param_specs`` cover train state, KV caches and params through the real
constructors on the ``meta`` device — shapes and dtypes only, nothing
materialised, at any config's full size.  Modality frontends are STUBS per
the task spec: [audio]/[vlm] get precomputed frame/patch embeddings
(enc_embeds) and M-RoPE position ids.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs.base import ModelConfig, SHAPES, ShapeConfig
from repro_torch.models import lm
from repro_torch.train.step import ParallelConfig, init_train_state

META = torch.device("meta")

# Encoder length for enc-dec decode shapes (speech frames after frontend).
ENC_LEN_DECODE = 4096


class _DrawOnMeta(TorchFunctionMode):
    """Sends every random draw (a call given a ``generator``) to the meta
    device: the constructors draw on their generator's device, the CPU."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if kwargs.pop("generator", None) is not None:
            kwargs["device"] = META
        return func(*args, **kwargs)


def _meta(x: Any, dtype) -> torch.Tensor:
    return torch.empty(x, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig | str,
                act_dtype=torch.bfloat16) -> Dict[str, Any]:
    if isinstance(shape, str):
        shape = SHAPES[shape]
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs: Dict[str, Any] = {
            "tokens": _meta((B, S), torch.int32),
            "labels": _meta((B, S), torch.int32),
        }
        if cfg.mrope:
            specs["positions"] = _meta((3, B, S), torch.int32)
        if cfg.encdec:
            specs["enc_embeds"] = _meta((B, S, cfg.d_model), act_dtype)
        if shape.kind == "prefill":
            del specs["labels"]
        return specs
    # decode: one new token against a seq_len-deep cache
    return {"tokens": _meta((B, 1), torch.int32),
            "pos": _meta((), torch.int32)}


def state_specs(cfg: ModelConfig, pcfg: ParallelConfig,
                param_dtype=torch.bfloat16):
    with _DrawOnMeta():
        return init_train_state(cfg, torch.Generator(), pcfg, param_dtype,
                                device=META)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig | str,
                cache_dtype=torch.bfloat16):
    if isinstance(shape, str):
        shape = SHAPES[shape]
    enc_len = ENC_LEN_DECODE if cfg.encdec else 0
    return lm.init_cache(cfg, shape.global_batch, max_len=shape.seq_len,
                         enc_len=enc_len, dtype=cache_dtype, device=META)


def param_specs(cfg: ModelConfig, param_dtype=torch.bfloat16):
    with _DrawOnMeta():
        return lm.init_lm(cfg, torch.Generator(), param_dtype, device=META)
