"""Model stack: layers, GQA and MLA attention (f32, bf16 or int8 KV), MoE,
mamba and RWKV-6 mixers and the LM assembly (ports of src/repro/models/;
enc-dec and M-RoPE are not ported yet)."""
