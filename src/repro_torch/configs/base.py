# Port of src/repro/configs/base.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""Model / shape configuration for the 10 assigned architectures."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention
    attn_kind: str = "gqa"        # gqa | mla | none
    qkv_bias: bool = False
    activation: str = "swiglu"    # swiglu | geglu
    rope_theta: float = 1e4
    mrope: bool = False           # qwen2-vl M-RoPE
    window: int = 0               # sliding-window size (local layers)
    swa_period: int = 0           # gemma3: every `period`-th layer is global
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1            # MoE at layers with (i % moe_every == moe_offset)
    moe_offset: int = 0
    capacity_factor: float = 1.25  # GShard-style expert capacity
    # MLA (DeepSeek-V2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # SSM / hybrid
    ssm_kind: str = ""            # "" | mamba | rwkv6
    attn_period: int = 0          # jamba: 1 attention layer per `attn_period`
    attn_offset: int = 4
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # enc-dec / multimodal
    encdec: bool = False
    n_enc_layers: int = 0
    frontend: str = ""            # "" | audio | vision — stub embeddings
    # numerics / training
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    remat: bool = True
    scan_chunk: int = 128         # ssm/rwkv time-scan chunk
    attn_block: int = 512         # chunked-attention KV block

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM / hybrid / sliding-window mixes."""
        return bool(self.ssm_kind) or self.swa_period > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Mixer kind per decoder layer."""
        kinds = []
        for i in range(self.n_layers):
            if self.ssm_kind == "rwkv6":
                kinds.append("rwkv")
            elif self.ssm_kind == "mamba":
                if self.attn_period and i % self.attn_period == self.attn_offset:
                    kinds.append("attn_full")
                else:
                    kinds.append("mamba")
            elif self.attn_kind == "mla":
                kinds.append("mla")
            elif self.swa_period and (i % self.swa_period != self.swa_period - 1):
                kinds.append("attn_local")
            else:
                kinds.append("attn_full")
        return tuple(kinds)

    def mlp_kinds(self) -> Tuple[str, ...]:
        kinds = []
        for i in range(self.n_layers):
            if self.ssm_kind == "rwkv6":
                kinds.append("rwkv_cm")
            elif self.n_experts and i % self.moe_every == self.moe_offset:
                kinds.append("moe")
            else:
                kinds.append("dense")
        return tuple(kinds)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def applicable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """long_500k only for sub-quadratic archs (DESIGN.md Sec. 4)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return tuple(names)


# ---------------------------------------------------------------------------
# Parameter counting (for roofline MODEL_FLOPS = 6*N*D).
# ---------------------------------------------------------------------------

def _attn_params(cfg: ModelConfig) -> int:
    if cfg.attn_kind == "mla":
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        return (cfg.d_model * cfg.q_lora_rank
                + cfg.q_lora_rank * cfg.n_heads * qk
                + cfg.d_model * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                + cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
                + cfg.n_heads * cfg.v_head_dim * cfg.d_model)
    hd = cfg.head_dim
    return (cfg.d_model * cfg.n_heads * hd + 2 * cfg.d_model * cfg.n_kv_heads * hd
            + cfg.n_heads * hd * cfg.d_model)


def _mamba_params(cfg: ModelConfig) -> int:
    d_in = cfg.expand * cfg.d_model
    dt_rank = math.ceil(cfg.d_model / 16)
    return (cfg.d_model * 2 * d_in + d_in * cfg.d_conv
            + d_in * (dt_rank + 2 * cfg.d_state) + dt_rank * d_in
            + d_in * cfg.d_state + 2 * d_in + d_in * cfg.d_model)


def _rwkv_params(cfg: ModelConfig) -> int:
    return 5 * cfg.d_model * cfg.d_model + 2 * 64 * cfg.d_model \
        + 2 * cfg.d_model * cfg.d_ff + cfg.d_model * cfg.d_model


def _dense_mlp_params(cfg: ModelConfig) -> int:
    return 3 * cfg.d_model * cfg.d_ff


def _moe_params(cfg: ModelConfig, active_only: bool) -> int:
    e = cfg.top_k if active_only else cfg.n_experts
    routed = 3 * cfg.d_model * cfg.moe_d_ff * e
    shared = 3 * cfg.d_model * cfg.moe_d_ff * cfg.n_shared_experts
    return routed + shared + cfg.d_model * cfg.n_experts


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Decoder (+encoder) parameter count; embeddings counted once."""
    total = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    for kind, mkind in zip(cfg.layer_kinds(), cfg.mlp_kinds()):
        if kind in ("attn_full", "attn_local"):
            total += _attn_params(cfg)
        elif kind == "mla":
            total += _attn_params(cfg)
        elif kind == "mamba":
            total += _mamba_params(cfg)
        if kind == "rwkv":
            total += _rwkv_params(cfg)
        elif mkind == "dense":
            total += _dense_mlp_params(cfg)
        elif mkind == "moe":
            total += _moe_params(cfg, active_only)
    if cfg.encdec:
        total += cfg.n_enc_layers * (_attn_params(cfg) + _dense_mlp_params(cfg))
        # decoder cross-attention
        total += cfg.n_layers * _attn_params(cfg)
    return total
