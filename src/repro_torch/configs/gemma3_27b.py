# Port of src/repro/configs/gemma3_27b.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5 local : 1 global sliding-window mix, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab_size=262144,
    activation="geglu", rope_theta=1e4,
    window=1024, swa_period=6,              # 5 local : 1 global
    tie_embeddings=True,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, window=16, swa_period=4, remat=False,
    attn_block=32, scan_chunk=8)
