# Port of src/repro/configs/qwen15_110b.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064 — QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=49152, vocab_size=152064,
    qkv_bias=True, activation="swiglu", rope_theta=1e6,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=512, remat=False, attn_block=32, scan_chunk=8)
