# Port of src/repro/configs/qwen2_vl_72b.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution.  Vision frontend is a STUB:
input_specs() provides precomputed patch embeddings / 3-part position ids.
[arXiv:2409.12191; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064,
    qkv_bias=True, activation="swiglu", rope_theta=1e6, mrope=True,
    frontend="vision",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=512, remat=False, attn_block=32, scan_chunk=8)
