# Port of src/repro/configs/deepseek_v2_236b.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""deepseek-v2-236b [moe]: 60L d_model=5120 128H, MLA kv_lora=512,
d_ff=1536/expert, 2 shared + 160 routed top-6, vocab=102400.
[arXiv:2405.04434; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=192,
    d_ff=12288, vocab_size=102400,
    attn_kind="mla", activation="swiglu", rope_theta=1e4,
    kv_lora_rank=512, q_lora_rank=1536,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536, moe_every=1,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=48,
    d_ff=128, vocab_size=512, kv_lora_rank=32, q_lora_rank=48,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    n_experts=8, n_shared_experts=1, top_k=2, moe_d_ff=64,
    capacity_factor=8.0, remat=False, attn_block=32, scan_chunk=8)
