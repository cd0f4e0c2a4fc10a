# Port of src/repro/configs/rwkv6_7b.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""rwkv6-7b [ssm]: 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536 —
Finch: data-dependent decay.  [arXiv:2404.05892; hf]"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab_size=65536,
    attn_kind="none", ssm_kind="rwkv6",
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=4, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
    d_ff=256, vocab_size=512, remat=False, attn_block=32, scan_chunk=8)
