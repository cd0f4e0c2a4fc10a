# Port of src/repro/configs/jamba_v01_52b.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE every other
layer.  [arXiv:2403.19887; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    activation="swiglu", rope_theta=1e4,
    ssm_kind="mamba", attn_period=8, attn_offset=4,
    d_state=16, d_conv=4, expand=2,
    n_experts=16, top_k=2, moe_d_ff=14336, moe_every=2, moe_offset=1,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, n_experts=4, top_k=2, moe_d_ff=128,
    d_state=4, capacity_factor=8.0, remat=False, attn_block=32, scan_chunk=8)
