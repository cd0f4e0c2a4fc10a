# Port of src/repro/configs/gemma_7b.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""gemma-7b [dense]: 28L d_model=3072 16H (MHA kv=16) d_ff=24576
vocab=256000 — GeGLU, head_dim=256.  [arXiv:2403.08295; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000,
    activation="geglu", rope_theta=1e4, tie_embeddings=True,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=512, remat=False, attn_block=32, scan_chunk=8)
