# Port of src/repro/configs/seamless_m4t_medium.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""seamless-m4t-medium [audio]: 12L enc + 12L dec, d_model=1024 16H
d_ff=4096 vocab=256206 — enc-dec, multimodal.  Audio frontend is a STUB:
input_specs() provides precomputed frame embeddings.  [arXiv:2308.11596; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206,
    activation="swiglu", rope_theta=1e4,
    encdec=True, n_enc_layers=12, frontend="audio",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=512, remat=False, attn_block=32,
    scan_chunk=8)
