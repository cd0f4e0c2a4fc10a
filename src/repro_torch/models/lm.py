# Port of src/repro/models/lm.py:42-177 and :331-496 in torch, for stacks of
# attn_full and attn_local (sliding-window, ring-buffer) mixers with dense
# MLPs: tinyllama-1.1b and gemma3-27b.
"""LM assembly: stages of a repeating layer group with stacked parameters.

Params and caches keep the reference's nested-dict layout and stacked
``(reps, ...)`` leaves — ``params["stage0"]["b0"]["mixer"]["wq"]`` is
(reps, d_model, H*D), ``cache["stage0"]["b0"]["k"]`` is (reps, B, L, K, D) —
so a snapshot's page bytes and a parameter tree converted from the reference
(``repro_torch.weights``) line up key for key.  The reference's ``lax.scan``
over reps is a Python loop over views of the stacked tensors.

Caches are updated IN PLACE (the reference's donated buffers): prefill writes
its tokens' K/V, decode writes one token per ACTIVE row only, so inactive
rows stay bit-exact without the reference's select over every cache leaf.
An ``attn_local`` layer keeps a ring of ``min(max_len, window)`` slots, token
t in slot ``t % L``, as the reference does (its ``lm.py:135-137``,
``:201-204``, ``:227-235``).

``attn_full`` and ``attn_local`` mixers with ``dense`` MLPs are ported; MLA,
mamba, rwkv, MoE, enc-dec and M-RoPE raise ``NotImplementedError`` (ROADMAP
Queue 1 item 13).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models.layers import (embed, init_embed, init_mlp, init_rms,
                                       mlp, rms_norm, unembed)

LayerSpec = Tuple[str, str]     # (mixer_kind, mlp_kind)
POS_SENTINEL = 2**30
PORTED = (("attn_full", "dense"), ("attn_local", "dense"))


def stages_of(cfg: ModelConfig) -> List[Tuple[int, Tuple[LayerSpec, ...]]]:
    kinds = list(zip(cfg.layer_kinds(), cfg.mlp_kinds()))
    n = len(kinds)
    for p in range(1, n + 1):
        if all(kinds[i] == kinds[i % p] for i in range(n)):
            reps, tail = n // p, n % p
            out = [(reps, tuple(kinds[:p]))]
            if tail:
                out.append((1, tuple(kinds[reps * p:])))
            return out
    return [(1, tuple(kinds))]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run."""
    bad = sorted({f"{m}+{f}" for m, f in zip(cfg.layer_kinds(),
                                             cfg.mlp_kinds())
                  if (m, f) not in PORTED})
    if bad or cfg.encdec or cfg.mrope:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {bad or ''}"
            f"{' enc-dec' if cfg.encdec else ''}"
            f"{' m-rope' if cfg.mrope else ''} are not ported yet (the port "
            f"runs attn_full and attn_local with dense MLPs); MLA, mamba, "
            f"rwkv, MoE, enc-dec and M-RoPE arrive with the other model "
            f"families' slice (ROADMAP Queue 1 item 13)")


def cache_len(cfg: ModelConfig, mixer_kind: str, max_len: int) -> int:
    """Slots of a layer's K/V cache: ``max_len``, or the sliding window's
    ring of ``min(max_len, window)`` for an ``attn_local`` layer."""
    if mixer_kind == "attn_local" and cfg.window > 0:
        return min(max_len, cfg.window)
    return max_len


# ---------------------------------------------------------------------------
# Init.
# ---------------------------------------------------------------------------

def init_lm(cfg: ModelConfig, generator: torch.Generator,
            dtype=torch.float32, device=None) -> Dict:
    """Random params in the reference's layout, drawn from ``generator``
    (on its device) and placed on ``device`` (default: cuda, raising
    without a GPU).  The numbers differ from the reference's ``init_lm``
    (torch and jax generators differ); the distributions are the same."""
    check_supported(cfg)
    dev = resolve_device(device)
    g = generator
    params: Dict[str, Any] = {
        "embed": init_embed(g, cfg.vocab_size, cfg.d_model, dtype, dev),
        "final_norm": init_rms(cfg.d_model, dev),
    }
    for i, (reps, group) in enumerate(stages_of(cfg)):
        stage = {}
        for j, _ in enumerate(group):
            stage[f"b{j}"] = {
                "ln1": torch.zeros((reps, cfg.d_model), device=dev),
                "mixer": A.init_gqa_params(g, cfg.d_model, cfg.n_heads,
                                           cfg.n_kv_heads, cfg.head_dim,
                                           cfg.qkv_bias, reps, dtype, dev),
                "ln2": torch.zeros((reps, cfg.d_model), device=dev),
                "mlp": init_mlp(g, cfg.d_model, cfg.d_ff, reps, dtype, dev),
            }
        params[f"stage{i}"] = stage
    if not cfg.tie_embeddings:
        params["head"] = init_embed(g, cfg.vocab_size, cfg.d_model, dtype,
                                    dev).T.contiguous()
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> Dict:
    """Zeroed K/V and sentinel positions: leaves (reps, batch, L, ...),
    with L from :func:`cache_len` (a ring for sliding-window layers).
    The K/V dtype is float32 or bfloat16: an int8 cache needs the
    reference's per-token scales, which arrive with int8 KV (ROADMAP Queue 1
    item 13, with K3d), and any other dtype would truncate the floats that
    prefill and decode write into it."""
    check_supported(cfg)
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"a {dtype} KV cache is not ported: the cache holds float32 or "
            f"bfloat16; int8 KV with its scales arrives with ROADMAP Queue 1 "
            f"item 13 (int8 KV, with K3d)")
    dev = resolve_device(device)
    cache: Dict[str, Any] = {}
    for i, (reps, group) in enumerate(stages_of(cfg)):
        stage = {}
        for j, (mixer_kind, _) in enumerate(group):
            L = cache_len(cfg, mixer_kind, max_len)
            shape = (reps, batch, L, cfg.n_kv_heads, cfg.head_dim)
            stage[f"b{j}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "pos": torch.full((reps, batch, L), POS_SENTINEL,
                                  dtype=torch.int32, device=dev)}
        cache[f"stage{i}"] = stage
    return cache


def reset_slot(cache: Dict, slot: int) -> None:
    """Return cache row ``slot`` to its init values, IN PLACE."""
    for st in cache.values():
        for c in st.values():
            c["k"][:, slot].zero_()
            c["v"][:, slot].zero_()
            c["pos"][:, slot].fill_(POS_SENTINEL)


# ---------------------------------------------------------------------------
# The stack.
# ---------------------------------------------------------------------------

def _layer(tree: Dict, r: int) -> Dict:
    """Rep ``r``'s view of a stacked (reps, ...) tree."""
    return {k: (_layer(v, r) if isinstance(v, dict) else v[r])
            for k, v in tree.items()}


def _run(cfg: ModelConfig, params: Dict, x: torch.Tensor,
         positions: torch.Tensor, mode: str, cache: Optional[Dict],
         slot: int, cache_index: Optional[torch.Tensor],
         rows: Optional[torch.Tensor]) -> torch.Tensor:
    B, Sq, _ = x.shape
    ring_index: Dict[int, torch.Tensor] = {}    # cache length -> write slots
    for i, (reps, group) in enumerate(stages_of(cfg)):
        for r in range(reps):
            for j, (mixer_kind, _) in enumerate(group):
                p = _layer(params[f"stage{i}"][f"b{j}"], r)
                c = (None if cache is None else
                     {k: t[r] for k, t in cache[f"stage{i}"][f"b{j}"].items()})
                h = rms_norm(x, p["ln1"], cfg.norm_eps)
                kv, idx = None, None
                if c is not None and mode == "decode":
                    kv = (c["k"], c["v"], c["pos"])
                    L = c["k"].shape[1]
                    if L not in ring_index:     # token t lives in slot t % L
                        ring_index[L] = cache_index % L
                    idx = ring_index[L]
                y, new = A.gqa_block(
                    p["mixer"], h, positions, n_heads=cfg.n_heads,
                    n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                    rope_theta=cfg.rope_theta,
                    window=cfg.window if mixer_kind == "attn_local" else 0,
                    block=cfg.attn_block, kv_cache=kv, cache_index=idx,
                    rows=rows)
                if c is not None and mode == "prefill":
                    _prefill_write(c, slot, new[0], new[1], positions)
                x = x + y
                x = x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps),
                            cfg.activation)
    return x


def _prefill_write(c: Dict, slot: int, k: torch.Tensor, v: torch.Tensor,
                   positions: torch.Tensor) -> None:
    """Write a prefill's K/V and positions into cache rows ``slot:slot+B``
    IN PLACE.  A ring of L < Sq slots keeps the last L tokens, rolled by
    ``(Sq - L) % L`` so that token t lands in slot ``t % L`` and later
    decodes (slot = position % L) overwrite the oldest entry first."""
    B, Sq = positions.shape
    L = c["k"].shape[1]
    take = min(Sq, L)
    roll = (Sq - take) % L
    for name, t in (("k", k), ("v", v), ("pos", positions)):
        tail = t[:, Sq - take:]
        c[name][slot:slot + B, :take] = (torch.roll(tail, roll, dims=1)
                                         if roll else tail)


def _logits(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"] if cfg.tie_embeddings else params["head"],
                   x, tied=cfg.tie_embeddings)


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[Dict] = None, mode: str = "train",
            slot: int = 0) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (logits, cache).  ``mode="prefill"`` writes the tokens' K/V
    and positions into cache rows ``slot:slot+B`` IN PLACE.  (The
    reference also returns an auxiliary loss, which only MoE layers make.)"""
    B, Sq = tokens.shape
    if positions is None:
        positions = torch.arange(Sq, dtype=torch.int32,
                                 device=tokens.device).expand(B, Sq)
    x = embed(params["embed"], tokens) * math.sqrt(cfg.d_model)
    x = _run(cfg, params, x, positions, mode, cache, slot, None, None)
    return _logits(cfg, params, x), cache


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            cache: Dict, positions: Optional[torch.Tensor] = None,
            slot: int = 0) -> Tuple[torch.Tensor, Dict]:
    """Prefill cache rows ``slot:slot+B`` IN PLACE.  Bucketed serving
    passes right-padded tokens with sentinel (2**30) positions for the
    pads, which keeps them causally invisible forever."""
    return forward(cfg, params, tokens, positions=positions, cache=cache,
                   mode="prefill", slot=slot)


def decode_step_batched(cfg: ModelConfig, params: Dict, cache: Dict,
                        tokens: torch.Tensor, pos: torch.Tensor,
                        active: Sequence[bool]
                        ) -> Tuple[torch.Tensor, Dict]:
    """One continuous-batching decode step for a ragged batch.

    tokens: (B,) int — last emitted token per slot; pos: (B,) int32 —
    per-slot positions; active: (B,) host booleans (numpy or a sequence:
    the host knows which slots serve a request, and reading a device mask
    here would sync).  Greedy sampling runs on the device.  Returns
    (next_tokens, cache): next_tokens is -1 for inactive slots, whose cache
    rows are left bit-exact."""
    from repro_torch import to_device

    dev = tokens.device
    act = np.asarray(active, dtype=bool)
    rows = to_device(np.flatnonzero(act), dev, torch.long)
    pos = pos.to(device=dev, dtype=torch.int32)
    x = embed(params["embed"], tokens[:, None]) * math.sqrt(cfg.d_model)
    x = _run(cfg, params, x, pos[:, None], "decode", cache, 0, pos, rows)
    logits = _logits(cfg, params, x)
    nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    mask = to_device(act, dev)
    return torch.where(mask, nxt, torch.full_like(nxt, -1)), cache
