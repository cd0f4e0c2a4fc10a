# Counterpart of src/repro/roofline/hlo.py: the reference walks the compiled
# HLO for one call's flops, bytes and collective traffic; the port has no
# HLO, so it counts the flops of its plain path and models the bytes.
"""One call's cost: flops, useful flops, bytes and collective bytes.

* ``flops`` is what the computation does: ``FlopCounterMode`` over the
  port's plain path (every tensor on the ``meta`` device, so a full-width
  call costs nothing to count).  It is the number held against the
  reference's HLO flops (``repro.roofline.hlo.analyze``), which count the
  same matmuls: reduced tinyllama's decode at 4 slots and ``max_len`` 96
  is 2,129,920 in both.  The plain attention scores every (query, key)
  pair of its block, valid or not.
* ``useful_flops`` counts attention over the valid (query, key) pairs
  only, the pairs K3 cannot skip: ``flops`` less the plain attention's
  all-pairs products, plus ``2 * H * (Dk + Dv)`` for each valid pair.
* ``bytes`` is analytic, each byte a call must move read or written once:
  the weights (of the embedding only the rows looked up), the K/V rows
  attention reads (the valid ones) and writes, the positions, and for a
  page move the snapshot read and written.
* ``link_bytes_total``, the collective bytes, comes from the mesh axes'
  byte counters (``launch/mesh.py``: each hop counts one device's shard),
  or for a layout with no devices from :func:`mesh_step_link_bytes`.

:func:`bound_ms` turns a cost into the least time the card could take:
the larger of the bytes at the HBM rate and the operations at the peak of
the units that run them (``roofline/analysis.py``).  :func:`attention_bound`
and :func:`tc_bound` give K3's own bounds at a call's shapes.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.dispatch import tensors
from repro_torch.models import lm
from repro_torch.roofline.analysis import (HBM_BW, PEAK_BF16_FLOPS,
                                           PEAK_F32_FLOPS, PEAK_TF32_FLOPS,
                                           peak_flops)

ATTENTION_KINDS = ("attn_full", "attn_local")


def to_meta(tree):
    """A tree of dicts, lists and (named) tuples with every tensor replaced
    by an empty one of its shape and dtype on the ``meta`` device."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_meta(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_meta(v) for v in tree)
    return tree


class _MetaShapes(TorchDispatchMode):
    """Answers the data-dependent ops the meta device cannot run with the
    shape they have in the model: ``bincount`` of expert ids (a router's
    expert counts) with its ``minlength`` bins, every id lying below it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten.bincount.default and args[0].is_meta:
            n = kwargs.get("minlength", args[2] if len(args) > 2 else 0)
            weights = kwargs.get("weights", args[1] if len(args) > 1
                                 else None)
            return torch.zeros(n, device="meta", dtype=(
                torch.int64 if weights is None else weights.dtype))
        return func(*args, **kwargs)


def count_flops(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """``{"flops": total, "by_op": {op: flops}}`` of one call of ``fn``
    (``FlopCounterMode``: matmuls, convolutions and attention ops); its
    tensors may lie on the meta device."""
    with FlopCounterMode(display=False) as fc, _MetaShapes():
        fn(*args, **kwargs)
    by_op = {str(k): int(v) for k, v in
             fc.get_flop_counts().get("Global", {}).items()}
    return {"flops": int(fc.get_total_flops()), "by_op": by_op}


def valid_pairs(q_pos, kv_pos, window: int = 0, causal: bool = True) -> int:
    """(query, key) pairs attention must score: per batch row, key
    position <= query position (every pair when not ``causal``), and
    within ``window`` of it when ``window > 0``.  ``q_pos`` (B, S) and
    ``kv_pos`` (B, T), host arrays or tensors."""
    qp = np.asarray(torch.as_tensor(q_pos).cpu())
    kp = np.asarray(torch.as_tensor(kv_pos).cpu())
    valid = (kp[:, None, :] <= qp[:, :, None] if causal else
             np.ones((kp.shape[0], qp.shape[1], kp.shape[1]), bool))
    if window > 0:
        valid &= kp[:, None, :] > qp[:, :, None] - window
    return int(valid.sum())


def attention_bound(q, k, q_pos, kv_pos, window, peak=PEAK_F32_FLOPS,
                    passes=1, dv=None, scale_bytes=0, causal=True):
    """(ms, "bytes" or "operations") of the least time the card could take
    for this attention: q read and the output written once (in q's dtype),
    positions read once, the K/V rows that some query of their batch row
    attends read once (in k's dtype, with ``scale_bytes`` of scales a kv
    head for an int8 row: its K and V scales, 8); 2*H*(Dk + Dv) FLOP per
    valid (query, key) pair (4*H*D where V's head dim ``dv`` is q's and
    K's), at the f32 peak (or, for the prefill kernel's own bound,
    ``passes`` products of each at a tensor-core peak: 3 TF32 ones for
    f32, one bf16).  Without ``causal`` every (query, key) pair is valid."""
    qp, kp = q_pos.cpu().numpy(), kv_pos.cpu().numpy()
    valid = (kp[:, None, :] <= qp[:, :, None] if causal else
             np.ones((kp.shape[0], qp.shape[1], kp.shape[1]), bool))
    if window > 0:
        valid &= kp[:, None, :] > qp[:, :, None] - window
    B, S, H, D = q.shape
    K = k.shape[2]
    dv = D if dv is None else dv
    rows = int(valid.any(1).sum())
    nbytes = (q.element_size() * B * S * H * (D + dv)
              + (k.element_size() * (D + dv) + scale_bytes) * rows * K
              + 4 * (qp.size + kp.size))
    flops = 2 * H * (D + dv) * int(valid.sum()) * passes
    t_bytes, t_ops = nbytes / HBM_BW, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def tc_bound(q, k, q_pos, kv_pos, window, dv=None, causal=True):
    """The prefill kernel's tensor-core bound (ms): one bf16 product when
    q and K/V are bf16, else 3xTF32 (any f32 operand takes that path)."""
    if q.dtype == torch.bfloat16 and k.dtype == torch.bfloat16:
        return attention_bound(q, k, q_pos, kv_pos, window,
                               PEAK_BF16_FLOPS, dv=dv, causal=causal)[0]
    return attention_bound(q, k, q_pos, kv_pos, window, PEAK_TF32_FLOPS,
                           3, dv=dv, causal=causal)[0]


# ---------------------------------------------------------------------------
# the serving entry points
# ---------------------------------------------------------------------------

def _attention_layers(cfg) -> list:
    kinds = cfg.layer_kinds()
    other = sorted({k for k in kinds if k not in ATTENTION_KINDS})
    if other:
        raise NotImplementedError(
            f"the cost model covers GQA attention layers; {cfg.name} has "
            f"{other}")
    return kinds


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(tree))


def _weight_bytes(params: Dict, rows: int) -> int:
    """The weights a forward over ``rows`` tokens reads: every leaf once,
    of the embedding table only the looked-up rows."""
    emb = params["embed"]
    return (_tree_bytes(params) - emb.numel() * emb.element_size()
            + min(rows, emb.shape[0]) * emb.shape[1] * emb.element_size())


def _kv_row_bytes(cfg, dtype) -> int:
    """One token's K and V in one attention layer."""
    return (cfg.n_kv_heads * 2 * cfg.head_dim
            * torch.empty((), dtype=dtype).element_size())


def _gemm_peak(params: Dict) -> float:
    return peak_flops(str(params["embed"].dtype).split(".")[-1])


def decode_cost(cfg, params: Dict, cache: Dict, pos: Sequence[int],
                active: Sequence[bool]) -> Dict[str, Any]:
    """The cost of one ``lm.decode_step_batched`` over ``cache`` for the
    rows whose host position is ``pos`` (each active row's new token at
    ``pos``, attending keys ``0..pos``, a local layer the last
    ``cfg.window`` of them)."""
    kinds = _attention_layers(cfg)
    act = np.asarray(active, bool)
    pos = np.asarray(pos, np.int64)
    B = len(act)
    tok = torch.empty(B, dtype=torch.int32, device="meta")
    got = count_flops(lm.decode_step_batched, cfg, to_meta(params),
                      to_meta(cache), tok, tok, act)
    kv_dtype = _cache_dtype(cache)
    H, D = cfg.n_heads, cfg.head_dim
    T = _cache_len(cache)
    attn_all = 2 * B * H * T * 2 * D * len(kinds)
    valid = []
    for kind in kinds:
        w = cfg.window if kind == "attn_local" else 0
        span = pos[act] + 1
        valid.append(int(np.minimum(span, w).sum()) if w > 0
                     else int(span.sum()))
    attn_valid = 2 * H * 2 * D * sum(valid)
    row = _kv_row_bytes(cfg, kv_dtype)
    nbytes = (_weight_bytes(params, int(act.sum()))
              + row * sum(valid)                       # K/V read
              + row * int(act.sum()) * len(kinds)      # the new K/V row
              + 4 * B * (T + 1) * len(kinds))          # positions
    return _cost(got, attn_all, attn_valid, nbytes, _gemm_peak(params),
                 PEAK_F32_FLOPS)


def prefill_cost(cfg, params: Dict, cache: Dict, tokens_len: int,
                 q_pos: Sequence[int]) -> Dict[str, Any]:
    """The cost of one ``lm.prefill`` of ``tokens_len`` tokens (a bucket)
    whose positions are ``q_pos`` (pads at 2**30) into one cache row."""
    kinds = _attention_layers(cfg)
    S = tokens_len
    tok = torch.empty((1, S), dtype=torch.int32, device="meta")
    got = count_flops(lm.prefill, cfg, to_meta(params), tok,
                      to_meta(cache), positions=tok)
    H, D = cfg.n_heads, cfg.head_dim
    qp = np.asarray(q_pos, np.int64).reshape(1, S)
    attn_all = 2 * S * H * S * 2 * D * len(kinds)
    attn_valid = 2 * H * 2 * D * sum(
        valid_pairs(qp, qp, cfg.window if kind == "attn_local" else 0)
        for kind in kinds)
    row = _kv_row_bytes(cfg, _cache_dtype(cache))
    nbytes = (_weight_bytes(params, S) + row * S * len(kinds)
              + 4 * 2 * S * len(kinds))
    # K3's f32 prefill runs on the tensor cores as three TF32 products
    attn_peak = (PEAK_BF16_FLOPS if str(params["embed"].dtype).endswith(
        "bfloat16") else PEAK_TF32_FLOPS / 3)
    return _cost(got, attn_all, attn_valid, nbytes, _gemm_peak(params),
                 attn_peak)


def page_move_cost(snapshots: int, snapshot_bytes: int,
                   n_pages: int) -> Dict[str, Any]:
    """A suspend, resume or migration of ``snapshots`` sessions: each
    snapshot read once and written once, and its per-page checksums
    (int64) written or read once.  No flops."""
    nbytes = snapshots * (2 * snapshot_bytes + 8 * n_pages)
    return {"flops": 0, "useful_flops": 0, "gemm_flops": 0,
            "attention_flops": 0, "bytes": int(nbytes),
            "link_bytes_total": 0, "gemm_peak": PEAK_F32_FLOPS,
            "attention_peak": PEAK_F32_FLOPS, "by_op": {}}


def tree_read_cost(tree) -> Dict[str, Any]:
    """A call that reads ``tree``'s tensors once and does no flops (the
    DRAM simulator over its trace and parameters)."""
    return {"flops": 0, "useful_flops": 0, "gemm_flops": 0,
            "attention_flops": 0, "bytes": _tree_bytes(tree),
            "link_bytes_total": 0, "gemm_peak": PEAK_F32_FLOPS,
            "attention_peak": PEAK_F32_FLOPS, "by_op": {}}


def _cost(got, attn_all, attn_valid, nbytes, gemm_peak, attn_peak):
    gemm = got["flops"] - attn_all
    if gemm < 0:
        raise ValueError(f"counted {got['flops']} flops, fewer than the "
                         f"plain attention's {attn_all}")
    return {"flops": got["flops"], "useful_flops": gemm + attn_valid,
            "gemm_flops": gemm, "attention_flops": attn_valid,
            "bytes": int(nbytes), "link_bytes_total": 0,
            "gemm_peak": gemm_peak, "attention_peak": attn_peak,
            "by_op": got["by_op"]}


def _cache_dtype(cache: Dict) -> torch.dtype:
    for st in cache.values():
        for c in st.values():
            if "k" in c:
                return c["k"].dtype
    raise ValueError("the cache holds no K/V")


def _cache_len(cache: Dict) -> int:
    for st in cache.values():
        for c in st.values():
            if "k" in c:
                return int(c["k"].shape[2])
    raise ValueError("the cache holds no K/V")


def bound_ms(cost: Dict[str, Any]) -> float:
    """The least time (ms) the card could take for ``cost``: its bytes at
    the HBM rate, or its operations at their units' peaks (the GEMMs at
    ``gemm_peak``, attention's valid pairs at ``attention_peak``),
    whichever is longer."""
    t_ops = (cost["gemm_flops"] / cost["gemm_peak"]
             + cost["attention_flops"] / cost["attention_peak"])
    return max(cost["bytes"] / HBM_BW, t_ops) * 1e3


def bound_by(cost: Dict[str, Any]) -> str:
    t_ops = (cost["gemm_flops"] / cost["gemm_peak"]
             + cost["attention_flops"] / cost["attention_peak"])
    return "bytes" if cost["bytes"] / HBM_BW >= t_ops else "operations"


# ---------------------------------------------------------------------------
# a mesh step's collectives, from its layout alone
# ---------------------------------------------------------------------------

def _elt(x) -> int:
    return torch.empty((), dtype=x.dtype).element_size()


def mesh_step_link_bytes(params, shardings, mesh, batch_axes: Sequence[str],
                         pcfg, cfg, backward: bool = True,
                         kinds: Optional[Dict[str, Dict[str, int]]] = None
                         ) -> Dict[str, int]:
    """{axis: link bytes one device sends a step}: the ring collectives of
    one mesh step (``train/step.py``), as ``train/shardings.py`` runs them
    over the axes' hops.  Each hop of a ring sends one device's current
    shard:

    * a leaf split over axes gathers along each, the minor axis first
      (``_gather``), ``n`` hops of the partly gathered slice an axis of
      ``n`` devices; a stacked leaf (``stage*``, reps on dim 0) gathers
      one rep at a time, twice under ``remat`` (the recompute), but along
      an axis that splits its reps dim once, whole;
    * its gradient reduce-scatters over each batch axis it is split over
      (``n - 1`` hops of the gradient's ``1/n`` chunk), the major axis
      first, as ``_grad_to_shards`` runs them;
    * a leaf whole along a batch axis all-reduces its gradient over it:
      ``n - 1`` hops of a ``1/n`` chunk (padded) to reduce and ``n`` to
      gather.

    Without ``backward`` (a serving step) only the forward's gathers
    count.  ``kinds``, if given, gathers each collective's hops and bytes
    by kind (``all-gather``, ``reduce-scatter``, ``all-reduce``).
    ``params`` may be meta tensors and ``mesh`` a layout with no devices
    (``launch/mesh.py::make_production_mesh``): only shapes are read.
    Under ``cfg.remat`` each stacked leaf's gathers run twice.  With
    ``pcfg.tensor_parallel`` the split compute keeps a leaf's ``model``
    split where it computes along the dim it is stored split on
    (``shardings.compute_dim``): no gather and no reduce-scatter over
    ``model``; a leaf every ``model`` device uses whole sums its gradient
    over ``model`` as over a batch axis.  The split compute's own
    collectives (the activations' reductions) are reductions, not hops,
    and are not counted here.
    """
    from repro_torch.models import sharding as SHD
    from repro_torch.train import shardings as SH
    from repro_torch.train import step as TS
    sizes = dict(mesh.shape)
    remat = bool(cfg.remat)
    out = {a: 0 for a in sizes}
    kinds = {} if kinds is None else kinds

    def add(kind, axis, n_hops, nbytes):
        out[axis] += nbytes
        rec = kinds.setdefault(kind, {"count": 0, "link_bytes": 0})
        rec["count"] += n_hops
        rec["link_bytes"] += nbytes

    flat = []
    SH.tree_map(lambda p, x, sh: flat.append((tuple(map(str, p)), x, sh)),
                params, shardings, with_path=True)
    tp = pcfg.tensor_parallel and sizes.get("model", 1) > 1
    compute = {}
    if tp:
        with SHD.use_sharding(mesh, TS.sharding_rules(pcfg),
                              batch_axes=tuple(batch_axes)):
            compute = {p: SH.compute_dim(list(p), x.shape, cfg)
                       for p, x, _ in flat}
    for path, x, sh in flat:
        reps = x.shape[0] if path[0].startswith("stage") else 1
        dims = dict(sh.dims())
        cd = compute.get(path)
        keep = ("model",) if (cd is not None
                              and dims.get(cd) == ("model",)) else ()
        sums = tuple(batch_axes) + (("model",) if tp and cd is None
                                    else ())
        lead = dims.get(0, ()) if reps > 1 else ()
        elt = _elt(x)
        local = list(sh.local_shape(x.shape))
        gathers = 2 if (remat and reps > 1) else 1
        # forward gathers: the reps dim's axes once, whole; then a rep at a
        # time over the rest (model_slice's reps-dim gather comes first)
        cur = list(local)
        for a in reversed(lead):
            n = sizes[a]
            if n > 1:
                add("all-gather", a, n, n * math.prod(cur) * elt)
                cur[0] *= n
        per_rep = list(cur[1:]) if reps > 1 else list(cur)
        for d, names in sh.dims():
            if reps > 1 and d == 0:
                continue
            dd = d - 1 if reps > 1 else d
            for a in reversed(names):
                n = sizes[a]
                if n > 1 and a not in keep:
                    add("all-gather", a, gathers * reps * n,
                        gathers * reps * n * math.prod(per_rep) * elt)
                    per_rep[dd] *= n
        if not backward:
            continue
        # backward: reduce-scatter over split batch axes, all-reduce over
        # the batch axes the leaf is whole along
        g = list(per_rep)
        for d, names in reversed(sh.dims()):
            if reps > 1 and d == 0:
                continue
            dd = d - 1 if reps > 1 else d
            for a in names:
                n = sizes[a]
                if n == 1 or a in keep:
                    continue
                g[dd] //= n
                if a in sums:
                    add("reduce-scatter", a, reps * (n - 1),
                        reps * (n - 1) * math.prod(g) * elt)
        grad_rep = math.prod(g)
        split = set(sh.axes())
        for a in sums:
            n = sizes[a]
            if a in split or n == 1:
                continue
            chunk = -(-grad_rep // n)
            add("all-reduce", a, reps * (2 * n - 1),
                reps * (2 * n - 1) * chunk * elt)
        for a in lead:
            n = sizes[a]
            if n > 1 and a in sums:
                add("reduce-scatter", a, n - 1,
                    (n - 1) * grad_rep * reps // n * elt)
    return out


def mesh_step_reduction_bytes(params, shardings, mesh,
                              batch_axes: Sequence[str], pcfg, cfg,
                              batch: int, seq: int,
                              backward: bool = True) -> Dict[str, int]:
    """{axis: bytes one device reduces a step}: the reductions (psum,
    pmax, and the split compute's all-reduces, all-gathers and
    reduce-scatters along a tensor dim) of one mesh step over a batch of
    ``batch`` x ``seq`` tokens, each counted at one device's operand:

    * the clip's norm, an f32 scalar for each leaf split over the axis,
      and with grad compression the scale's pmax, another;
    * the metrics, ``len(train.step._METRICS)`` f32 on each batch axis;
    * with ``tensor_parallel`` on ``model`` (``m`` devices): the block
      outputs' all-reduces of (local rows, seq, d_model) activations,
      forward and backward, for the embedding where the vocab splits and
      in each layer for attention where the heads split and the MLP where
      ``d_ff`` does; under ``sequence_parallel`` four more a layer and two
      for the final norm, of a ``1/m`` sequence chunk; the cross
      entropy's pmax and psums, five of (local rows, seq) f32 where the
      vocab splits; and the backward all-gather of each rep of a leaf the
      compute cuts otherwise than its storage (its ``1/m`` compute slice);
      under ``remat`` each layer's forward reductions once more (the
      recompute).

    Without ``backward`` (a serving step: ``make_prefill_step``,
    ``make_serve_step``) only the forward's activation all-reduces count.
    The activation count is the dense GQA block's: an MoE, MLA, mamba or
    rwkv layer's own collectives are counted as one attention and one MLP
    block's."""
    from repro_torch.models import sharding as SHD
    from repro_torch.train import shardings as SH
    from repro_torch.train import step as TS
    sizes = dict(mesh.shape)
    out = {a: 0 for a in sizes}
    flat = []
    SH.tree_map(lambda p, x, sh: flat.append((tuple(map(str, p)), x, sh)),
                params, shardings, with_path=True)
    m = sizes.get("model", 1)
    tp = pcfg.tensor_parallel and m > 1
    elt = _elt(flat[0][1])
    rows = batch // math.prod(sizes[a] for a in batch_axes)
    act = rows * seq * cfg.d_model * elt
    vs = cfg.vocab_size % m == 0
    block = ((2 if cfg.n_heads % m == 0 else 0)
             + (2 if cfg.d_ff % m == 0 else 0))
    if not backward:
        if tp:
            out["model"] += ((1 if vs else 0)
                             + cfg.n_layers * block // 2) * act
        return out
    per_norm = 2 if pcfg.grad_compress else 1
    for _, x, sh in flat:
        for a in sh.axes():
            if sizes[a] > 1:
                out[a] += 4 * per_norm
    for a in batch_axes:
        out[a] += 4 * len(TS._METRICS)
    if not tp:
        return out
    out["model"] += ((2 if vs else 0) + cfg.n_layers * block) * act
    if pcfg.sequence_parallel:
        out["model"] += (4 * cfg.n_layers + 2) * act // m
    if cfg.remat:
        # the recompute replays each layer's forward reductions
        out["model"] += cfg.n_layers * (
            block // 2 * act + (2 * act // m if pcfg.sequence_parallel
                                else 0))
    if vs:
        out["model"] += 5 * rows * seq * 4
    with SHD.use_sharding(mesh, TS.sharding_rules(pcfg),
                          batch_axes=tuple(batch_axes)):
        for path, x, sh in flat:
            cd = SH.compute_dim(list(path), x.shape, cfg)
            if cd is None or dict(sh.dims()).get(cd) == ("model",):
                continue
            reps = x.shape[0] if path[0].startswith("stage") else 1
            out["model"] += x.numel() // m * _elt(x)
    return out
