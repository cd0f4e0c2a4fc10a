# Port of src/repro/configs/__init__.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""Assigned-architecture configs (--arch <id>)."""
from repro_torch.configs.base import (ModelConfig, ShapeConfig, SHAPES,
                                applicable_shapes, param_count)

from repro_torch.configs import (gemma3_27b, qwen15_110b, tinyllama_11b, gemma_7b,
                           jamba_v01_52b, qwen2_vl_72b, rwkv6_7b, olmoe_1b_7b,
                           deepseek_v2_236b, seamless_m4t_medium)

_MODULES = {
    "gemma3-27b": gemma3_27b,
    "qwen1.5-110b": qwen15_110b,
    "tinyllama-1.1b": tinyllama_11b,
    "gemma-7b": gemma_7b,
    "jamba-v0.1-52b": jamba_v01_52b,
    "qwen2-vl-72b": qwen2_vl_72b,
    "rwkv6-7b": rwkv6_7b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "seamless-m4t-medium": seamless_m4t_medium,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    return _MODULES[name].CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _MODULES[name].REDUCED
