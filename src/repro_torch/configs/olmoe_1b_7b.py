# Port of src/repro/configs/olmoe_1b_7b.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024 (per
expert) vocab=50304, MoE 64e top-8.  [arXiv:2409.02060; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304,
    activation="swiglu", rope_theta=1e4,
    n_experts=64, top_k=8, moe_d_ff=1024, moe_every=1,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=64, vocab_size=512, n_experts=8, top_k=2, moe_d_ff=64,
    capacity_factor=8.0, remat=False, attn_block=32, scan_chunk=8)
