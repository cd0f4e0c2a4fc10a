# Port of src/repro/models/lm.py:42-177, :184-325 and :331-496 in torch,
# for stacks of attn_full, attn_local (sliding-window, ring-buffer), MLA,
# mamba and rwkv mixers with dense, MoE or rwkv channel-mix MLPs, with RoPE
# or M-RoPE, decoder-only or enc-dec (a bidirectional encoder and cross
# attention in every decoder block), over f32, bf16 or int8 (quantised,
# with per-token scales) KV caches: every config in configs/.
"""LM assembly: stages of a repeating layer group with stacked parameters.

Params and caches keep the reference's nested-dict layout and stacked
``(reps, ...)`` leaves — ``params["stage0"]["b0"]["mixer"]["wq"]`` is
(reps, d_model, H*D), ``cache["stage0"]["b0"]["k"]`` is (reps, B, L, K, D),
an MLA layer's ``cc``/``cr`` (reps, B, L, kv_lora) and (reps, B, L, rope),
a mamba layer's ``conv``/``ssm`` and an rwkv layer's ``att_shift``,
``ffn_shift`` and ``wkv`` its recurrent state — so a snapshot's page bytes
and a parameter tree converted from the reference (``repro_torch.weights``)
line up key for key.  The reference's ``lax.scan`` over reps is a Python
loop over views of the stacked tensors.

Caches are updated IN PLACE (the reference's donated buffers): prefill writes
its tokens' K/V (an MLA layer's latent and shared key, a recurrent layer's
final state), decode writes one token (or one state) per ACTIVE row only,
so inactive rows stay bit-exact without the reference's select over every
cache leaf.
An ``attn_local`` layer keeps a ring of ``min(max_len, window)`` slots, token
t in slot ``t % L``, as the reference does (its ``lm.py:135-137``,
``:201-204``, ``:227-235``).

An int8 cache (``init_cache(dtype=torch.int8)``) holds quantised K/V (or
MLA latents) and their f32 scales; as in the reference, only decode reaches
it (:func:`decode_step`, :func:`decode_step_batched`), and a prefill into
it raises.  The state leaves ``ssm`` and ``wkv`` are f32 in every cache;
``conv`` and the shifts take the cache's dtype.

An enc-dec config (seamless-m4t) runs as the reference's: ``init_cache(...,
enc_len=T)`` adds each decoder block's ``enc_k``/``enc_v``/``enc_pos``,
:func:`prefill` with ``enc_embeds`` (B, T, d_model) runs the encoder
(:func:`_encode`) and writes its projected K/V into the cache, and
:func:`decode_step` reads them from there.  Under M-RoPE (qwen2-vl)
positions are (3, B, S) temporal/height/width ids; the temporal ids are
the causal positions and the ones a cache holds, and decode broadcasts one
position to all three.

Under ``cfg.remat`` (every full config's; the reduced ones set it off)
with grad on, each rep of a stage's layer group and each encoder layer
runs checkpointed, as the reference's scan body under ``jax.checkpoint``
(its ``lm.py:349-350``, ``:390``): the backward recomputes the rep's
forward, and in the mesh steps gathers its params again.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as R
from repro_torch.models import sharding as SHD
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import (apply_rope, embed, init_embed,
                                       init_mlp, init_rms, mlp, rms_norm,
                                       unembed)

LayerSpec = Tuple[str, str]     # (mixer_kind, mlp_kind)
POS_SENTINEL = 2**30
RECURRENT = ("mamba", "rwkv")
# a layer's cache leaves that hold a recurrent state, not tokens; of them
# ssm and wkv stay f32 in a cache of any dtype
STATE_LEAVES = ("conv", "ssm", "att_shift", "ffn_shift", "wkv")
F32_STATE = ("ssm", "wkv")


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
    (torch and jax generators differ); the distributions are the same.
    An enc-dec config adds a ``cross`` block and ``ln_cross`` to every
    decoder block, the ``encoder`` stage of ``n_enc_layers``
    ``("attn_full", "dense")`` blocks and ``enc_norm``, as the reference's
    (its ``lm.py:75-123``)."""
    dev = resolve_device(device)
    g = generator
    params: Dict[str, Any] = {
        "embed": init_embed(g, cfg.vocab_size, cfg.d_model, dtype, dev),
        "final_norm": init_rms(cfg.d_model, dev),
    }
    for i, (reps, group) in enumerate(stages_of(cfg)):
        stage = {}
        for j, (mixer_kind, mlp_kind) in enumerate(group):
            if mixer_kind == "mla":
                mixer = A.init_mla_params(
                    g, cfg.d_model, cfg.n_heads, cfg.q_lora_rank,
                    cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                    cfg.v_head_dim, reps, dtype, dev)
            elif mixer_kind == "mamba":
                mixer = SSM.init_mamba_params(g, cfg.d_model, cfg.d_state,
                                              cfg.d_conv, cfg.expand, reps,
                                              dtype, dev)
            elif mixer_kind == "rwkv":
                mixer = R.init_rwkv_params(g, cfg.d_model, cfg.d_ff, reps,
                                           dtype, dev)
            else:
                mixer = A.init_gqa_params(g, cfg.d_model, cfg.n_heads,
                                          cfg.n_kv_heads, cfg.head_dim,
                                          cfg.qkv_bias, reps, dtype, dev)
            block = {"ln1": torch.zeros((reps, cfg.d_model), device=dev),
                     "mixer": mixer,
                     "ln2": torch.zeros((reps, cfg.d_model), device=dev)}
            if mlp_kind == "moe":
                block["mlp"] = MOE.init_moe_params(
                    g, cfg.d_model, cfg.n_experts, cfg.moe_d_ff,
                    cfg.n_shared_experts, reps, dtype, dev)
            elif mlp_kind == "dense":
                block["mlp"] = init_mlp(g, cfg.d_model, cfg.d_ff, reps,
                                        dtype, dev)
            # rwkv_cm: the channel-mix params live in the mixer
            if cfg.encdec:
                block["ln_cross"] = torch.zeros((reps, cfg.d_model),
                                                device=dev)
                block["cross"] = A.init_cross_params(
                    g, cfg.d_model, cfg.n_heads, cfg.head_dim, reps, dtype,
                    dev)
            stage[f"b{j}"] = block
        params[f"stage{i}"] = stage
    if not cfg.tie_embeddings:
        params["head"] = init_embed(g, cfg.vocab_size, cfg.d_model, dtype,
                                    dev).T.contiguous()
    if cfg.encdec:
        reps = cfg.n_enc_layers
        params["encoder"] = {"b0": {
            "ln1": torch.zeros((reps, cfg.d_model), device=dev),
            "mixer": A.init_gqa_params(g, cfg.d_model, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.head_dim,
                                       cfg.qkv_bias, reps, dtype, dev),
            "ln2": torch.zeros((reps, cfg.d_model), device=dev),
            "mlp": init_mlp(g, cfg.d_model, cfg.d_ff, reps, dtype, dev)}}
        params["enc_norm"] = init_rms(cfg.d_model, dev)
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None, enc_len: int = 0) -> Dict:
    """Zeroed K/V and sentinel positions: leaves (reps, batch, L, ...),
    with L from :func:`cache_len` (a ring for sliding-window layers); an
    MLA layer holds its compressed cache, ``cc`` (kv_lora wide) and ``cr``
    (qk_rope wide), instead of K/V; a mamba layer its ``conv`` history and
    f32 ``ssm`` state, an rwkv layer its ``att_shift``/``ffn_shift`` tokens
    and f32 ``wkv`` state.  ``dtype`` is float32, bfloat16 or int8: an int8
    cache adds the reference's f32 scale leaves, ``k_scale``/``v_scale``
    (reps, batch, L, K), or ``cc_scale``/``cr_scale`` (reps, batch, L) for
    MLA (its ``lm.py:141-152``).  Any other dtype raises: it would truncate
    the floats that prefill and decode write into it.  An enc-dec config
    adds to every block the cross attention's ``enc_k``/``enc_v`` (reps,
    batch, enc_len, n_heads, head_dim) in the cache's dtype and
    ``enc_pos`` (reps, batch, enc_len) at 2**30, which a prefill fills
    (its ``lm.py:163-166``)."""
    if dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise NotImplementedError(
            f"a {dtype} KV cache is not ported: the cache holds float32, "
            f"bfloat16 or int8 with per-token scales, as the reference's "
            f"serving paths (ROADMAP Queue 3 F1)")
    dev = resolve_device(device)
    cache: Dict[str, Any] = {}
    for i, (reps, group) in enumerate(stages_of(cfg)):
        stage = {}
        for j, (mixer_kind, _) in enumerate(group):
            L = cache_len(cfg, mixer_kind, max_len)
            d_inner = cfg.expand * cfg.d_model
            scale_shape = (reps, batch, L)        # MLA: one scale a token
            if mixer_kind == "mla":
                shapes = {"cc": (reps, batch, L, cfg.kv_lora_rank),
                          "cr": (reps, batch, L, cfg.qk_rope_dim)}
            elif mixer_kind == "mamba":
                shapes = {"conv": (reps, batch, cfg.d_conv - 1, d_inner),
                          "ssm": (reps, batch, d_inner, cfg.d_state)}
            elif mixer_kind == "rwkv":
                heads = cfg.d_model // R.HEAD_DIM
                shapes = {"att_shift": (reps, batch, cfg.d_model),
                          "ffn_shift": (reps, batch, cfg.d_model),
                          "wkv": (reps, batch, heads, R.HEAD_DIM,
                                  R.HEAD_DIM)}
            else:
                kv = (reps, batch, L, cfg.n_kv_heads, cfg.head_dim)
                shapes = {"k": kv, "v": kv}
                scale_shape = kv[:-1]             # one a token and kv head
            c = {name: torch.zeros(shape, device=dev, dtype=(
                torch.float32 if name in F32_STATE else dtype))
                for name, shape in shapes.items()}
            if mixer_kind not in RECURRENT:       # a cache of tokens
                c["pos"] = torch.full((reps, batch, L), POS_SENTINEL,
                                      dtype=torch.int32, device=dev)
                if dtype == torch.int8:
                    for name in shapes:
                        c[f"{name}_scale"] = torch.zeros(
                            scale_shape, dtype=torch.float32, device=dev)
            if cfg.encdec:
                enc = (reps, batch, enc_len, cfg.n_heads, cfg.head_dim)
                c["enc_k"] = torch.zeros(enc, dtype=dtype, device=dev)
                c["enc_v"] = torch.zeros(enc, dtype=dtype, device=dev)
                c["enc_pos"] = torch.full(enc[:3], POS_SENTINEL,
                                          dtype=torch.int32, device=dev)
            stage[f"b{j}"] = c
        cache[f"stage{i}"] = stage
    return cache


def reset_slot(cache: Dict, slot: int) -> None:
    """Return cache row ``slot`` to its init values, IN PLACE."""
    for st in cache.values():
        for c in st.values():
            for name, t in c.items():
                if name in ("pos", "enc_pos"):
                    t[:, slot].fill_(POS_SENTINEL)
                else:
                    t[:, slot].zero_()


# ---------------------------------------------------------------------------
# The stack.
# ---------------------------------------------------------------------------

def _layer(tree: Dict, r: int) -> Dict:
    """Rep ``r``'s view of a stacked (reps, ...) tree."""
    return {k: (_layer(v, r) if isinstance(v, dict) else v[r])
            for k, v in tree.items()}


def _norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return SHD.norm(rms_norm, x, scale, eps)


def _remat(fn, *args):
    """``fn(*args)`` under activation checkpointing (the reference's
    ``jax.checkpoint``): its activations are recomputed in the backward,
    params gathered inside ``fn`` gathered again.  The recompute replays
    all of ``fn`` (no early stop), so each collective in it runs once
    more, in the same order on every rank, and in the forward's sharding
    context wherever the backward runs."""
    c = SHD.ctx()
    with ckpt.set_checkpoint_early_stop(False):
        return ckpt.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False,
            context_fn=lambda: (contextlib.nullcontext(),
                                SHD.installed(c)))


def _run(cfg: ModelConfig, params: Dict, x: torch.Tensor,
         positions: torch.Tensor, mode: str, cache: Optional[Dict],
         slot: int, cache_index: Optional[torch.Tensor],
         rows: Optional[torch.Tensor],
         enc_out: Optional[torch.Tensor] = None, moe_groups: int = 0,
         sp: bool = False
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The stack over ``x``; returns (x, the MoE layers' summed aux loss,
    None where no layer is MoE or in decode, which has no use for it).
    An enc-dec config's blocks attend over ``enc_out``, the encoder's
    output, or in decode over the cache's ``enc_k``/``enc_v``.  Each rep
    of a stage's layer group is one step of the reference's scan, its
    carry ``(x, aux)``; under ``cfg.remat`` with grad on and no cache it
    runs checkpointed (:func:`_remat`), its params indexed (in the mesh
    steps: gathered) inside.  In a sharding context each block's input
    is all-gathered on S under ``sp`` and its output reduced over the
    model axis where it holds partial sums (``models/sharding.py``)."""
    ring_index: Dict[int, torch.Tensor] = {}    # cache length -> write slots
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    aux = None
    for i, (reps, group) in enumerate(stages_of(cfg)):
        stage = params[f"stage{i}"]
        cst = None if cache is None else cache[f"stage{i}"]

        def rep(x, aux, r, group=group, stage=stage, cst=cst):
            c = None if cst is None else {
                b: {k: t[r] for k, t in cb.items()} for b, cb in cst.items()}
            return _group(cfg, group, _layer(stage, r), c, x, aux,
                          positions, mode, slot, cache_index, rows,
                          ring_index, enc_out, moe_groups, sp)
        for r in range(reps):
            x, aux = _remat(rep, x, aux, r) if remat else rep(x, aux, r)
    return x, aux


def _group(cfg: ModelConfig, group: Tuple[LayerSpec, ...], ps: Dict,
           cs: Optional[Dict], x: torch.Tensor, aux: Optional[torch.Tensor],
           positions: torch.Tensor, mode: str, slot: int,
           cache_index: Optional[torch.Tensor],
           rows: Optional[torch.Tensor], ring_index: Dict[int, torch.Tensor],
           enc_out: Optional[torch.Tensor], moe_groups: int, sp: bool
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One rep of a stage's layer group over ``(x, aux)``: ``ps`` its
    params, ``cs`` its cache leaves (None without a cache)."""
    for j, (mixer_kind, mlp_kind) in enumerate(group):
        p = ps[f"b{j}"]
        c = None if cs is None else cs[f"b{j}"]
        h = SHD.gather_in(_norm(x, p["ln1"], cfg.norm_eps), sp)
        st = None if c is None else _state_rows(c, mode, slot, x.shape[0])
        updates: Dict[str, torch.Tensor] = {}
        if mixer_kind == "mamba":
            y, new = SSM.mamba_block(
                p["mixer"], h, d_state=cfg.d_state, d_conv=cfg.d_conv,
                expand=cfg.expand, state=None if st is None else
                SSM.MambaState(st["conv"], st["ssm"]))
            if new is not None:
                updates.update(conv=new.conv, ssm=new.ssm)
            rows_of = ("out_proj", cfg.expand * cfg.d_model)
        elif mixer_kind == "rwkv":
            y, new = R.rwkv_time_mix(
                p["mixer"], h, state=None if st is None else
                R.RWKVState(st["att_shift"], st["ffn_shift"], st["wkv"]))
            if new is not None:
                updates.update(att_shift=new[0], wkv=new[1])
            rows_of = ("wo", cfg.d_model)
        else:
            y = _attention(cfg, mixer_kind, p, c, h, positions, mode, slot,
                           cache_index, rows, ring_index)
            rows_of = ("wo", cfg.n_heads * (cfg.v_head_dim if mixer_kind
                                             == "mla" else cfg.head_dim))
        x = x + SHD.reduce_out(y, _partial(p["mixer"], *rows_of), sp)
        if cfg.encdec:
            x = x + _cross(cfg, p, c, x, mode, slot, enc_out, sp)
        h = SHD.gather_in(_norm(x, p["ln2"], cfg.norm_eps), sp)
        if mlp_kind == "moe":
            y, aux_l = MOE.moe_block(
                p["mlp"], h, top_k=cfg.top_k,
                capacity_factor=cfg.capacity_factor, n_groups=moe_groups,
                activation=cfg.activation, aux_loss=mode != "decode",
                shared_ff=cfg.n_shared_experts * cfg.moe_d_ff, sp=sp)
            if aux_l is not None:
                aux = aux_l if aux is None else aux + aux_l
        elif mlp_kind == "rwkv_cm":
            y, shift = R.rwkv_channel_mix(
                p["mixer"], h, state=None if st is None else
                R.RWKVState(None, st["ffn_shift"], None), ff=cfg.d_ff)
            y = SHD.reduce_out(y, False, sp)
            if shift is not None:
                updates["ffn_shift"] = shift
        else:
            y = SHD.reduce_out(mlp(p["mlp"], h, cfg.activation),
                               _partial(p["mlp"], "wo", cfg.d_ff), sp)
        x = x + y
        if updates:
            _state_write(c, updates, mode, slot, rows)
    return x, aux


def _partial(p: Dict, name: str, full: int) -> bool:
    """Whether the row-parallel weight ``p[name]`` is a slice of its
    ``full`` rows: its product is then a partial sum."""
    return p[name].shape[-2] < full


def _attention(cfg: ModelConfig, mixer_kind: str, p: Dict,
               c: Optional[Dict], h: torch.Tensor, positions: torch.Tensor,
               mode: str, slot: int, cache_index: Optional[torch.Tensor],
               rows: Optional[torch.Tensor],
               ring_index: Dict[int, torch.Tensor]) -> torch.Tensor:
    """One attention layer (GQA, full or windowed, or MLA) of
    :func:`_run`: in decode over its cache (int8 with its scales), in
    prefill writing its tokens' entries into cache rows ``slot:``."""
    kv, idx, scales = None, None, None
    if c is not None and mode == "decode":
        L = c["pos"].shape[1]
        if L not in ring_index:                 # token t lives in slot t % L
            ring_index[L] = cache_index % L
        idx = ring_index[L]
    if mixer_kind == "mla":
        if idx is not None:
            kv = (c["cc"], c["cr"], c["pos"])
            if "cc_scale" in c:
                scales = (c["cc_scale"], c["cr_scale"])
        y, new = A.mla_block(
            p["mixer"], h, positions, n_heads=cfg.n_heads,
            q_lora=cfg.q_lora_rank, kv_lora=cfg.kv_lora_rank,
            qk_nope=cfg.qk_nope_dim, qk_rope=cfg.qk_rope_dim,
            v_dim=cfg.v_head_dim, rope_theta=cfg.rope_theta,
            block=cfg.attn_block, kv_cache=kv, cache_index=idx, rows=rows,
            kv_scales=scales)
        written = ("cc", "cr")
    else:
        if idx is not None:
            kv = (c["k"], c["v"], c["pos"])
            if "k_scale" in c:
                scales = (c["k_scale"], c["v_scale"])
        y, new = A.gqa_block(
            p["mixer"], h, positions, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, mrope=cfg.mrope,
            window=cfg.window if mixer_kind == "attn_local" else 0,
            block=cfg.attn_block, kv_cache=kv, cache_index=idx, rows=rows,
            kv_scales=scales)
        written = ("k", "v")
    if c is not None and mode == "prefill":
        tok_pos = positions[0] if cfg.mrope else positions
        _prefill_write(c, slot, dict(zip(written, new), pos=tok_pos))
    return y


def _cross(cfg: ModelConfig, p: Dict, c: Optional[Dict], x: torch.Tensor,
           mode: str, slot: int, enc_out: Optional[torch.Tensor],
           sp: bool = False) -> torch.Tensor:
    """A decoder block's cross attention (the reference's
    ``lm.py:286-301``): over the encoder output's projected K/V, which a
    prefill also writes into cache rows ``slot:`` (every frame valid,
    position 0); decode reads them from the cache and never recomputes
    them.  In a sharding context over the device's heads, the cache's
    ``enc_k``/``enc_v`` those heads', its output in the layout between
    blocks."""
    hc = SHD.gather_in(_norm(x, p["ln_cross"], cfg.norm_eps), sp)
    if c is not None and mode == "decode":
        enc_k, enc_v, enc_pos = c["enc_k"], c["enc_v"], c["enc_pos"]
    else:
        enc_k, enc_v = A.encode_kv(p["cross"], enc_out, cfg.n_heads,
                                   cfg.head_dim)
        enc_pos = torch.zeros(enc_out.shape[:2], dtype=torch.int32,
                              device=x.device)
        if c is not None:
            B = x.shape[0]
            c["enc_k"][slot:slot + B] = enc_k
            c["enc_v"][slot:slot + B] = enc_v
            c["enc_pos"][slot:slot + B] = enc_pos
    y = A.cross_block(p["cross"], hc, (enc_k, enc_v), enc_pos == 0,
                      n_heads=cfg.n_heads, head_dim=cfg.head_dim)
    return SHD.reduce_out(y, _partial(p["cross"], "wo",
                                    cfg.n_heads * cfg.head_dim), sp)


def _state_rows(c: Dict, mode: str, slot: int, B: int
                ) -> Optional[Dict[str, torch.Tensor]]:
    """A recurrent layer's state leaves as this call reads them: rows
    ``slot:slot+B`` in prefill, every row in decode; None for a layer
    without any."""
    st = {k: t for k, t in c.items() if k in STATE_LEAVES}
    if not st:
        return None
    if mode == "prefill":
        return {k: t[slot:slot + B] for k, t in st.items()}
    return st


def _state_write(c: Dict, updates: Dict[str, torch.Tensor], mode: str,
                 slot: int, rows: Optional[torch.Tensor]) -> None:
    """Write a recurrent layer's new state IN PLACE, in each leaf's dtype:
    rows ``slot:slot+B`` in prefill; in decode the ACTIVE rows only, so an
    inactive row keeps its bits (the reference selects the old leaves for
    it, its ``lm.py:478-481``)."""
    for name, val in updates.items():
        buf = c[name]
        if mode == "prefill":
            buf[slot:slot + val.shape[0]] = val
        else:
            buf.index_put_((rows,), val[rows].to(buf.dtype))


def _prefill_write(c: Dict, slot: int, leaves: Dict[str, torch.Tensor]
                   ) -> None:
    """Write a prefill's cache entries (``leaves``: K/V, or an MLA
    layer's latent and shared key, and ``pos``, each (B, Sq, ...)) into
    cache rows ``slot:slot+B`` IN PLACE.  A ring of L < Sq slots keeps the
    last L tokens, rolled by ``(Sq - L) % L`` so that token t lands in slot
    ``t % L`` and later decodes (slot = position % L) overwrite the oldest
    entry first."""
    B, Sq = leaves["pos"].shape
    L = c["pos"].shape[1]
    take = min(Sq, L)
    roll = (Sq - take) % L
    for name, t in leaves.items():
        tail = t[:, Sq - take:]
        c[name][slot:slot + B, :take] = (torch.roll(tail, roll, dims=1)
                                         if roll else tail)


def _logits(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    x = _norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params["embed"] if cfg.tie_embeddings else params["head"],
                   x, tied=cfg.tie_embeddings)


def _embed(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
           sp: bool = False) -> torch.Tensor:
    """The scaled embedding; in a sharding context vocab-parallel where the
    table is split (its partial rows reduced over the model axis), in the
    layout between blocks."""
    x = embed(params["embed"], tokens, cfg.vocab_size)
    if SHD.active():
        x = SHD.reduce_out(x, params["embed"].shape[-2] < cfg.vocab_size,
                           sp)
    return x * math.sqrt(cfg.d_model)


def _default_positions(cfg: ModelConfig, B: int, Sq: int,
                       device) -> torch.Tensor:
    """``arange(Sq)`` for every row: (B, Sq), or (3, B, Sq) under
    M-RoPE (the reference's ``lm.py:360-365``)."""
    pos = torch.arange(Sq, dtype=torch.int32, device=device).expand(B, Sq)
    return pos.expand(3, B, Sq) if cfg.mrope else pos


def _encode(cfg: ModelConfig, params: Dict,
            enc_embeds: torch.Tensor) -> torch.Tensor:
    """The bidirectional encoder over the frontend's frame embeddings
    (B, T, d_model), the reference's ``lm.py:368-393``: RoPE at
    ``arange(T)``, attention with ``causal=False``, no bias; each layer
    checkpointed under ``cfg.remat`` with grad on, as the reference's
    scan body.  In a sharding context over the device's heads and ``ff``
    slice, each block's partial output all-reduced over the model axis."""
    B, T, _ = enc_embeds.shape
    D = cfg.head_dim
    pos = torch.arange(T, dtype=torch.int32,
                       device=enc_embeds.device).expand(B, T)
    enc = params["encoder"]["b0"]

    def layer(x, r):
        p = _layer(enc, r)
        h = _norm(x, p["ln1"], cfg.norm_eps)
        q = SHD.matmul(h, p["mixer"]["wq"]).reshape(B, T, -1, D)
        k = SHD.matmul(h, p["mixer"]["wk"]).reshape(B, T, -1, D)
        v = SHD.matmul(h, p["mixer"]["wv"]).reshape(B, T, -1, D)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        out = A.chunked_attention(q, k, v, pos, pos, causal=False,
                                  block=cfg.attn_block)
        y = SHD.matmul(out.reshape(B, T, -1), p["mixer"]["wo"])
        x = x + SHD.reduce_out(y, _partial(p["mixer"], "wo",
                                         cfg.n_heads * D), False)
        y = mlp(p["mlp"], _norm(x, p["ln2"], cfg.norm_eps), cfg.activation)
        return x + SHD.reduce_out(y, _partial(p["mlp"], "wo", cfg.d_ff),
                                  False)

    remat = cfg.remat and torch.is_grad_enabled()
    x = enc_embeds
    for r in range(cfg.n_enc_layers):
        x = _remat(layer, x, r) if remat else layer(x, r)
    return _norm(x, params["enc_norm"], cfg.norm_eps)


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[Dict] = None, mode: str = "train",
            slot: int = 0, enc_embeds: Optional[torch.Tensor] = None,
            moe_groups: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """Returns (logits, aux_loss, cache), as the reference's: the aux loss
    sums the MoE layers' load-balance losses (a 0 scalar without MoE).
    ``mode="prefill"`` writes the tokens' cache entries and positions (a
    recurrent layer's final state) into cache rows ``slot:slot+B`` IN
    PLACE; into an int8 cache it raises ``TypeError``, as the reference's
    prefill does (its ``lm.py:231-235`` writes float K/V into the int8
    buffer): only decode quantises.  ``positions`` default to ``arange``,
    (3, B, S) under M-RoPE.  An enc-dec config takes ``enc_embeds`` (B,
    T, d_model) and raises ``ValueError`` without them; a prefill also
    writes the cross attention's K/V, and raises ``ValueError`` where T is
    not the cache's ``enc_len`` (the reference would replace the cache's
    leaves with ones of T frames; the port writes its caches in place).
    ``moe_groups`` > 0 routes the MoE layers in that many token groups.
    In a sharding context (``models/sharding.py``: the mesh steps) the
    batch is the mesh's folded one, the params each device's compute
    slices, and the logits come out split over the vocab where the head
    is."""
    if cfg.encdec and enc_embeds is None:
        raise ValueError(f"{cfg.name} is enc-dec: forward and prefill take "
                         f"enc_embeds (B, T, d_model)")
    if cfg.encdec and mode == "prefill":
        enc_len = cache["stage0"]["b0"]["enc_k"].shape[2]
        if enc_embeds.shape[1] != enc_len:
            raise ValueError(
                f"enc_embeds hold {enc_embeds.shape[1]} frames, the cache "
                f"enc_len={enc_len}: init_cache(..., enc_len=) must match "
                f"the frames a prefill writes")
    if mode == "prefill" and any(t.dtype == torch.int8
                                 for st in cache.values()
                                 for c in st.values() for t in c.values()):
        raise TypeError(
            "prefill into an int8 cache: the reference cannot prefill one "
            "(it writes float K/V into the int8 buffer); an int8 cache is "
            "filled token by token through decode_step")
    B, Sq = tokens.shape
    if positions is None:
        positions = _default_positions(cfg, B, Sq, tokens.device)
    sp = SHD.sp_on(Sq)
    x = _embed(cfg, params, tokens, sp)
    enc_out = _encode(cfg, params, enc_embeds) if cfg.encdec else None
    x, aux = _run(cfg, params, x, positions, mode, cache, slot, None, None,
                  enc_out, moe_groups, sp)
    if aux is None:
        aux = torch.zeros((), device=x.device)
    return _logits(cfg, params, SHD.gather_in(x, sp)), aux, cache


def prefill(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
            cache: Dict, positions: Optional[torch.Tensor] = None,
            slot: int = 0, enc_embeds: Optional[torch.Tensor] = None,
            moe_groups: int = 0) -> Tuple[torch.Tensor, Dict]:
    """Prefill cache rows ``slot:slot+B`` IN PLACE.  Bucketed serving
    passes right-padded tokens with sentinel (2**30) positions for the
    pads, which keeps them causally invisible forever (an MoE layer routes
    the pads as the reference's does: they take capacity).  An enc-dec
    config takes the frame embeddings ``enc_embeds`` (B, enc_len,
    d_model) and writes their cross-attention K/V too."""
    logits, _, cache = forward(cfg, params, tokens, positions=positions,
                               cache=cache, mode="prefill", slot=slot,
                               enc_embeds=enc_embeds, moe_groups=moe_groups)
    return logits, cache


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor, pos, moe_groups: int = 0
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step at a uniform position, the reference's
    ``lm.decode_step`` (its ``lm.py:423-445``).  tokens: (B, 1); pos: the
    scalar position of every row (an int or a 0-d tensor), under M-RoPE
    all three of its ids.  Every row's cache entry is written IN PLACE, at
    slot ``pos % L`` of each layer's L slots; an int8 cache quantises on
    write; an enc-dec config attends over the cache's cross K/V.  Returns
    (logits (B, 1, V), cache)."""
    from repro_torch import to_device

    B, Sq = tokens.shape
    if Sq != 1:
        raise ValueError(f"decode_step takes tokens (B, 1) (got {Sq} a row)")
    dev = tokens.device
    pos = (pos.to(device=dev, dtype=torch.int32)
           if isinstance(pos, torch.Tensor)
           else to_device(int(pos), dev, torch.int32)).reshape(())
    idx = pos.expand(B)
    rows = torch.arange(B, device=dev)
    x = _embed(cfg, params, tokens)
    x, _ = _run(cfg, params, x, _step_positions(cfg, idx), "decode", cache,
                0, idx, rows, moe_groups=moe_groups)
    return _logits(cfg, params, x), cache


def _step_positions(cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    """A decode step's positions from the rows' (B,) positions: (B, 1),
    or under M-RoPE (3, B, 1), one position for all three ids (the
    reference's ``lm.py:432``, ``:464``)."""
    pos = pos[:, None]
    return pos.expand(3, *pos.shape) if cfg.mrope else pos


def decode_step_batched(cfg: ModelConfig, params: Dict, cache: Dict,
                        tokens: torch.Tensor, pos: torch.Tensor,
                        active: Sequence[bool], moe_groups: int = 0
                        ) -> Tuple[torch.Tensor, Dict]:
    """One continuous-batching decode step for a ragged batch.

    tokens: (B,) int — last emitted token per slot; pos: (B,) int32 —
    per-slot positions; active: (B,) host booleans (numpy or a sequence:
    the host knows which slots serve a request, and reading a device mask
    here would sync).  Greedy sampling runs on the device.  Returns
    (next_tokens, cache): next_tokens is -1 for inactive slots, whose cache
    rows are left bit-exact."""
    from repro_torch import to_device

    act = np.asarray(active, dtype=bool)
    logits = decode_logits(cfg, params, cache, tokens, pos, act, moe_groups)
    nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
    mask = to_device(act, tokens.device)
    return torch.where(mask, nxt, torch.full_like(nxt, -1)), cache


def decode_logits(cfg: ModelConfig, params: Dict, cache: Dict,
                  tokens: torch.Tensor, pos: torch.Tensor,
                  active: Sequence[bool], moe_groups: int = 0
                  ) -> torch.Tensor:
    """The logits (B, 1, V) of one decode step of
    :func:`decode_step_batched`, which writes the active rows' cache
    entries IN PLACE as it does."""
    from repro_torch import to_device

    dev = tokens.device
    rows = to_device(np.flatnonzero(np.asarray(active, dtype=bool)), dev,
                     torch.long)
    pos = pos.to(device=dev, dtype=torch.int32)
    x = _embed(cfg, params, tokens[:, None])
    x, _ = _run(cfg, params, x, _step_positions(cfg, pos), "decode", cache,
                0, pos, rows, moe_groups=moe_groups)
    return _logits(cfg, params, x)
