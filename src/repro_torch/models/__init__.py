"""Model stack: layers, GQA attention and the LM assembly (ports of
src/repro/models/, attn_full + dense stacks only)."""
