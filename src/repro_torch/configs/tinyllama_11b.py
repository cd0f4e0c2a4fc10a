# Port of src/repro/configs/tinyllama_11b.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""tinyllama-1.1b [dense]: 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000 — llama2-arch small.  [arXiv:2401.02385; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=64,
    d_ff=5632, vocab_size=32000,
    activation="swiglu", rope_theta=1e4,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=176, vocab_size=512, remat=False, attn_block=32, scan_chunk=8)
