# Port of src/repro/kernels/flash_attention.py::flash_attention (:81-131) as
# the CUDA kernels of csrc/flash_prefill_wgmma.cu (all-bf16 prefill),
# csrc/flash_attention.cu (the other prefills) and csrc/flash_decode.cu
# (decode), in the contract of src/repro/models/attention.py::
# chunked_attention (:37-126).
"""Launch wrapper of the attention kernels (K3) and the (B,H,S,D) layout
wrapper around them.

:func:`chunked_attention` launches the kernels on CUDA tensors in the
serving model's layout — q (B,S,H,D), k/v (B,T,K,D), per-row positions —
checks device, dtype, contiguity and shape, launches on
q's device's current stream, allocates its output with ``torch.empty``,
raises if the launch reports an error, and counts its calls in
``chunked_attention.launches``, one a launch, and by route in
``chunked_attention.prefill`` and ``chunked_attention.decode``.  Decode
(S = 1) runs the split-KV kernel, laid out by :func:`decode_plan`, with its
partials and tickets in a workspace kept per device and stream
(:func:`_workspace`).  Prefill (S > 1) runs one of two tensor-core kernels,
picked by shape (:func:`prefill_route`) and laid out by
:func:`prefill_plan`: q, k and v all bf16 at tile widths 64, 128 and 256
or at Dk 192 / Dv 128 the warpgroup-MMA kernel fed by TMA (``"wgmma"``,
also counted in ``chunked_attention.prefill_wgmma``), every other the
warp-level MMA kernel (``"mma"``), whose f32 path has a short form for
short buckets (``PrefillPlan.form`` "short", also counted in
``chunked_attention.prefill_short``).  q/k/v that do not start on a 16-byte
boundary, which both kernels' vector loads need, are copied first.  It
takes the reference's causal and sliding-window masks (``window > 0``, the
``attn_local`` layers), any GQA group, every head dim that is a multiple of
8 from 8 to 512 (each runs in the kernels' template of its
:func:`tile_width`, reading q, K and V where they lie at their true head
dim: nothing is padded or copied), and q in another float dtype than k/v
(bf16 weights over an f32 cache): the kernels read each in its own dtype
and promote as the reference does, so nothing is cast here.  On the
prefill route it also takes Dk 192 / Dv 128 (MLA's expanded K and V), with
q and k/v both f32 or both bf16.  What it refuses, in ROADMAP Queue 2's
order: a head dim above 512 or not a multiple of 8 (``ValueError``, K3f),
float16 (``ValueError``, K3g), Dv != Dk in decode (S = 1:
``NotImplementedError``, K3c; MLA decodes through its absorbed einsums),
int8 K/V at S > 1 (``NotImplementedError``, K3d) and int8 decode outside
:data:`INT8_DECODE` (``ValueError``, K3d); also another pair of head dims,
k and v of different dtypes and mixed dtypes at Dv != Dk
(``ValueError``).  int8 K/V come with the reference's per-token, per-head f32
scales, ``k_scale``/``v_scale`` (B,T,K), on the decode route (K3d): the
decode kernel dequantises each key and value as it loads them, for the (q
dtype, head dim, head group) triples of :data:`INT8_DECODE`, the ones the
int8 decode paths launch, and counts them in
``chunked_attention.decode_int8`` too.  int8 at S > 1 raises
``NotImplementedError`` (K3d's prefill: the reference cannot prefill an
int8 cache, so no path reaches it), another triple ``ValueError``.  CPU
tensors never reach it:
:mod:`repro_torch.kernels.ops` routes them to the plain chunked twin.

:func:`flash_attention` is the reference kernel's own signature: q
(B,H,S,D), k/v (B,K,T,D), q rows at the tail of the kv sequence
(``q_pos = i + T - S``).  It builds those positions and goes through the
same dispatch, so on the card it runs the same kernels.

:func:`train_attention` (K3e) is the prefill kernel under autograd, for
the training forward: ``kernels/ops.py`` takes it where grad is enabled
and q, k or v requires grad.  Its forward also writes each row's
log-sum-exp, and its backward is the kernel of csrc/flash_backward.cu
(:func:`attention_backward`: dQ, dK and dV from the saved output and
log-sum-exp), on every shape :func:`backward_route` gives it: every head
dim up to 256, in every dtype pair.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.scales import check_scales

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = None
_DECODE_LIB = None
_WGMMA_LIB = None
_BACKWARD_LIB = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {**_DTYPES, torch.int8: 2}
# (q dtype, head dim, head group) of the int8 decode instantiations
# (csrc/flash_decode.cu): tinyllama, gemma3's ring and global layers and
# jamba's attention layers, f32 q
INT8_DECODE = ((torch.float32, 64, 8), (torch.float32, 128, 2),
               (torch.float32, 128, 4))
# the split-KV decode kernel's layout (csrc/flash_decode.cu)
DECODE_CTAS_PER_SM = 4      # the grid aims at this many CTAs an SM
SPLIT_ALIGN = 16            # a split's length is a multiple of this
MAX_SPLITS = 512            # the most splits the kernel's combine takes
# the kernels' tile widths: a head dim that is one of TILE_WIDTHS runs in
# that width's unpadded template; any other in the padded template (its
# loads and stores masked past the head dim, the tile's other columns zero
# in shared memory) of the smallest of PADDED_WIDTHS at or above it
TILE_WIDTHS = (16, 32, 64, 128, 256, 512)
PADDED_WIDTHS = (64, 96, 128, 256, 512)
MAX_HEAD_DIM = TILE_WIDTHS[-1]
MLA_DIMS = (192, 128)       # (Dk, Dv) the prefill kernel also takes
# the prefill kernel's layout (csrc/flash_attention.cu, namespace pf)
PREFILL_ROWS = 128          # (query, head) rows a CTA: 8 warps of 16
PREFILL_KEYS = 64           # keys a K/V tile (32 above width 256)
PREFILL_STAGES = 2          # K/V tiles in flight (cp.async ring)
WIDE_D = 128                # above it 2 warps share a row block (4 above 256)
# the all-bf16 prefill on warpgroup MMAs and TMA (csrc/flash_prefill_wgmma.cu):
# its tile widths of Dk (192: MLA's Dk 192 / Dv 128), 128 rows a CTA (two
# consumer warpgroups of 64), and keys a tile and tiles in flight by width.
# Width 96 keeps the mma.sync template: no config has a head dim from 72
# to 96, and at 128 such a head would multiply 25-44% zero columns.
WGMMA_WIDTHS = (64, 128, 256, 192)
WGMMA_ROWS = 128
WGMMA_KEYS = {64: 128, 128: 128, 256: 64, 192: 128}
WGMMA_STAGES = {64: 4, 128: 2, 256: 2, 192: 2}
# the short form of the mma route's f32 path (csrc/flash_attention.cu,
# prefill_short_kernel: four warps a CTA): the (Dk, Dv) it takes, whole
# groups, q and K/V f32; the rows a CTA it may hold, in the order tried; the
# most keys it takes (a short bucket: at most 8 tiles)
SHORT_DIMS = ((64, 64), (128, 128), (256, 256), MLA_DIMS)
SHORT_ROWS = (64, 32, 16)
SHORT_MAX_KEYS = 512


def tile_width(head_dim: int) -> int:
    """The tile width the kernels run ``head_dim`` in: itself where it is
    one of :data:`TILE_WIDTHS`, else the smallest of :data:`PADDED_WIDTHS`
    at or above it (zero columns at most a quarter of the tile at 72 -> 96
    and 224 -> 256; none at 96, which has no unpadded template).  Raises
    ``ValueError`` for a head dim the kernels do not take."""
    if head_dim % 8 or not 8 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(
            f"head_dim {head_dim}: the kernels take a multiple of 8 from 8 to "
            f"{MAX_HEAD_DIM} (ROADMAP Queue 2 K3f: a head dim above 512 or "
            f"not a multiple of 8 is not ported)")
    if head_dim in TILE_WIDTHS:
        return head_dim
    return next(w for w in PADDED_WIDTHS if w >= head_dim)


def _lanes(width: int, vec: int) -> int:
    """Floats of a head a decode lane holds at tile ``width``: a row's
    ``width // vec`` chunks go to the largest power of two of lanes (at
    most 32) that divides them."""
    n = width // vec
    return width // min(32, n & -n)


def _lib() -> ctypes.CDLL:
    """The prefill kernel's library (``csrc/flash_attention.cu``), with
    its shared-memory opt-in."""
    global _LIB
    if _LIB is None:
        lib = _build.library("flash_attention")
        lib.flash_prefill_launch.argtypes = (
            [_P] * 8 + [_I] * 9 + [ctypes.c_float] + [_I] * 9 + [_P])
        lib.flash_prefill_short_launch.argtypes = (
            [_P] * 6 + [_I] * 9 + [ctypes.c_float] + [_I] * 6 + [_P])
        lib.flash_prefill_short_per_sm.argtypes = [_I] * 4
        lib.flash_attention_prepare.argtypes = []
        for fn in (lib.flash_prefill_launch, lib.flash_prefill_short_launch,
                   lib.flash_prefill_short_per_sm,
                   lib.flash_attention_prepare):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _wgmma_lib() -> ctypes.CDLL:
    """The all-bf16 prefill kernel's library
    (``csrc/flash_prefill_wgmma.cu``)."""
    global _WGMMA_LIB
    if _WGMMA_LIB is None:
        lib = _build.library("flash_prefill_wgmma")
        lib.flash_prefill_wgmma_launch.argtypes = (
            [_P] * 7 + [_I] * 9 + [ctypes.c_float] + [_I] * 7 + [_P])
        lib.flash_prefill_wgmma_prepare.argtypes = []
        for fn in (lib.flash_prefill_wgmma_launch,
                   lib.flash_prefill_wgmma_prepare):
            fn.restype = ctypes.c_int
        _WGMMA_LIB = lib
    return _WGMMA_LIB


def _backward_lib() -> ctypes.CDLL:
    """K3e's backward kernels' library (``csrc/flash_backward.cu``)."""
    global _BACKWARD_LIB
    if _BACKWARD_LIB is None:
        lib = _build.library("flash_backward")
        lib.flash_backward_launch.argtypes = (
            [_P] * 17 + [_I] * 8 + [ctypes.c_float] + [_I] * 3 + [_P])
        lib.flash_backward_prepare.argtypes = []
        for fn in (lib.flash_backward_launch, lib.flash_backward_prepare):
            fn.restype = ctypes.c_int
        _BACKWARD_LIB = lib
    return _BACKWARD_LIB


def _decode_lib() -> ctypes.CDLL:
    """The split-KV decode kernel's library (``csrc/flash_decode.cu``)."""
    global _DECODE_LIB
    if _DECODE_LIB is None:
        lib = _build.library("flash_decode")
        lib.flash_decode_launch.argtypes = (
            [_P] * 10 + [_I] * 8 + [ctypes.c_float] + [_I] * 5 + [_P])
        lib.flash_decode_launch.restype = ctypes.c_int
        _DECODE_LIB = lib
    return _DECODE_LIB


@functools.lru_cache(maxsize=None)
def decode_plan(B: int, K: int, G: int, T: int, itemsize: int, n_sm: int,
                head_dim: int) -> Tuple[int, int, int, int]:
    """``(head_group, n_groups, n_split, split_len)`` of the split-KV
    decode kernel for B batch rows, K kv heads of G query heads each, T
    cache slots of ``itemsize``-byte elements (the cache's: q may be
    another dtype) and ``head_dim`` on ``n_sm`` SMs.

    The kernel runs at ``tile_width(head_dim)``.  A lane holds F floats of
    a head's q and accumulator (:func:`_lanes`), in loads of ``vec``
    values: a 16-byte K/V chunk of a row (``16 // itemsize``), or 4 int8
    values (4 bytes) for an int8 cache; F is ``max(vec, width // 32)`` at
    a power-of-two width (two loads at 256 in f32, where the 32 lanes of a
    warp share one row), 12 (f32) or 24 (bf16) at 96.  A CTA holds
    ``head_group`` query heads (2, 4 or 8: the smallest power of two >= G,
    at most 32 floats of q and of accumulator a lane, so 8 in f32 up to head
    dim 128, else 4; 2 where F is above 16), so a kv head needs ``n_groups``
    CTAs, whatever G.  The slots
    are cut into ``n_split`` contiguous splits of ``split_len`` (a multiple
    of SPLIT_ALIGN), enough that the grid ``n_split * K * n_groups * B``
    reaches DECODE_CTAS_PER_SM CTAs an SM where T allows, at most
    MAX_SPLITS; n_split = ceil(T / split_len), so no split is empty and
    there is at least one."""
    vec = 4 if itemsize == 1 else 16 // itemsize
    cap = max(2, 32 // _lanes(tile_width(head_dim), vec))
    head_group = min(cap, max(2, 1 << max(0, G - 1).bit_length()))
    n_groups = -(-G // head_group)
    want = min(MAX_SPLITS,
               -(-DECODE_CTAS_PER_SM * n_sm // max(1, B * K * n_groups)))
    per = -(-max(T, 1) // want)
    split_len = -(-per // SPLIT_ALIGN) * SPLIT_ALIGN
    return head_group, n_groups, -(-max(T, 1) // split_len), split_len


def prefill_route(q_dtype: torch.dtype, kv_dtype: torch.dtype,
                  head_dim: int, v_dim: int) -> str:
    """The prefill kernel a call runs, by its dtypes and head dims:
    ``"wgmma"`` (csrc/flash_prefill_wgmma.cu) where q and k/v are all bf16
    and Dk = Dv has a tile width of 64, 128 or 256, or (Dk, Dv) is
    :data:`MLA_DIMS`; ``"mma"`` (csrc/flash_attention.cu) for every other
    shape it takes: f32, mixed dtypes, widths 16, 32, 96 and 512.  Raises
    ``ValueError`` for head dims the kernels do not take."""
    mla = (head_dim, v_dim) == MLA_DIMS
    if not mla and head_dim != v_dim:
        raise ValueError(f"head_dim {head_dim} / {v_dim}: the prefill takes "
                         f"Dk = Dv or Dk {MLA_DIMS[0]} / Dv {MLA_DIMS[1]}")
    width = MLA_DIMS[0] if mla else tile_width(head_dim)
    bf16 = q_dtype == kv_dtype == torch.bfloat16
    return "wgmma" if bf16 and width in WGMMA_WIDTHS else "mma"


class PrefillPlan(NamedTuple):
    rows: int                    # (query, head) rows a CTA
    keys: int                    # keys a tile
    stages: int                  # tiles in flight
    bq: int                      # queries a CTA
    grid: Tuple[int, int, int]   # (query blocks x head slices, kv heads,
                                 #  batch rows)
    heads: int                   # heads of one kv head a CTA (a slice)
    width: int                   # the instantiation's tile width of Dk
    route: str                   # the kernel (prefill_route)
    form: str = "full"           # the mma route's layout: "full", "short"
    halves: int = 1              # CTAs a row's output columns are cut over


@functools.lru_cache(maxsize=None)
def prefill_plan(B: int, S: int, H: int, K: int, head_dim: int,
                 f32: bool, v_dim: int, *, T: Optional[int] = None,
                 n_sm: Optional[int] = None, lse: bool = False,
                 mixed: bool = False,
                 per_sm: Optional[Tuple[int, ...]] = None,
                 short_rows: Optional[int] = None) -> PrefillPlan:
    """The prefill kernel's layout for q (B,S,H,Dk) over K kv heads, Dk =
    ``head_dim`` and Dv = ``v_dim``, run at tile width ``width`` =
    ``tile_width(Dk)`` (192 for MLA's Dk 192 / Dv 128): a CTA holds ``bq =
    rows // heads`` queries of ``heads = min(G, rows)`` of the G = H / K
    heads of one kv head (:func:`prefill_row`): all of them where they fit
    a CTA's rows, else one slice of ceil(G / heads) slices (in the
    kernel's general template, which also runs the padded head dims: a
    whole group at a width of :data:`TILE_WIDTHS` runs its unpadded one,
    with no slice math).  It walks the keys in tiles of ``keys`` through a ring of ``stages``; the grid is one
    CTA per (query block, head slice), kv head and batch row.  ``rows`` is
    PREFILL_ROWS up to a Dv width of WIDE_D, half that up to 256, where two
    warps share each 16-row block, and a quarter at 512 (four warps).
    Tiles hold PREFILL_KEYS keys, half that at width 512.  Above a Dk width
    of WIDE_D the f32 path (``f32``: q or K/V is f32) has one stage, since
    its Q and one K/V tile fill the CTA's shared memory.  All-bf16 inputs
    (``f32`` False) at a width of :data:`WGMMA_WIDTHS` take the ``"wgmma"``
    route (:func:`prefill_route`): WGMMA_ROWS rows at every width, keys
    and stages from WGMMA_KEYS and WGMMA_STAGES, the same rows and grid
    otherwise.  That layout is ``form`` "full".

    Given the keys ``T`` and the card's SM count ``n_sm`` (the wrapper
    passes the device's), the mma route's f32 path takes the "short" form
    (csrc/flash_attention.cu, ``prefill_short_kernel``) where the full one
    would leave the card underused: its grid at most half a wave of
    ``n_sm`` CTAs, or its CTAs' rows at least half empty (S at most half a
    block's queries: MLA's 128 rows at S 64). Only for q and K/V all f32
    (``f32`` and not ``mixed``: bf16 q over f32 K/V, which no path
    prefills at a short bucket, keeps the full form), a (Dk, Dv) of
    :data:`SHORT_DIMS` with the whole group in a CTA, at most
    :data:`SHORT_MAX_KEYS` keys, and never with ``lse`` (K3e's forward
    keeps its kFresh form): every other shape keeps the full form, bit for
    bit. Between half a wave and one, and past 512 keys, the full form
    stays: on an H100 it was the faster at gemma-7b's and gemma3's buckets
    there and at olmoe's 1024 keys, the short form only at tinyllama's
    bucket 512 (prefill_forms.py, PERF.md §6). ``short_rows`` lays out a
    shape the short form takes at that many rows a CTA whatever the
    criterion says (the tests and prefill_forms.py time and check each
    instantiation so). A short CTA has four warps and ``rows`` = 16, 32 or 64
    rows, ``bq = rows // G`` queries of its kv head's G heads; the 64 /
    rows warps of a 16-row block split each tile's keys between them, so
    fewer rows a CTA means less work a warp and more CTAs; at Dv 256 the
    two output halves of a row go to two CTAs (``halves`` 2: the grid's x
    is query block x half, :func:`prefill_cols`). ``rows`` is the fewest
    of those whose grid takes the fewest waves, a wave ``n_sm`` times the
    CTAs an SM holds at that many rows (``per_sm``, aligned with
    :data:`SHORT_ROWS`: the card's occupancy of each instantiation, which
    the wrapper asks the card for; 1 where not given): one wave where any
    fits, since a second costs more than the split saves; past one wave
    (MLA's bucket 64 at B 2-8) 32 rows at two CTAs an SM beat 64 at one in
    as many waves (prefill_forms.py, PERF.md §6)."""
    if (head_dim, v_dim) == MLA_DIMS:
        width, v_width = MLA_DIMS[0], MLA_DIMS[1]
    else:
        width = v_width = tile_width(head_dim)
    G = H // K
    if G < 1 or H % K:
        raise ValueError(f"{H} heads over {K} kv heads: H must be a "
                         f"multiple of K")
    route = prefill_route(torch.float32 if f32 else torch.bfloat16,
                          torch.bfloat16, head_dim, v_dim)
    if route == "wgmma":
        rows, keys = WGMMA_ROWS, WGMMA_KEYS[width]
        stages = WGMMA_STAGES[width]
    else:
        rows = PREFILL_ROWS // (4 if v_width > 256 else
                                2 if v_width > WIDE_D else 1)
        keys = PREFILL_KEYS // 2 if width > 256 else PREFILL_KEYS
        stages = 1 if width > WIDE_D and f32 else PREFILL_STAGES
    heads = min(G, rows)
    bq = rows // heads
    grid = (-(-S // bq) * -(-G // heads), K, B)
    full = PrefillPlan(rows, keys, stages, bq, grid, heads, width, route)
    if (T is None or route != "mma" or not f32 or mixed or lse
            or (head_dim, v_dim) not in SHORT_DIMS or T > SHORT_MAX_KEYS
            or G > SHORT_ROWS[0]):
        return full
    halves = 2 if v_width > WIDE_D else 1
    if short_rows is None:
        if n_sm is None or (2 * grid[0] * K * B > n_sm
                            and 2 * S * heads > rows):
            return full
        occ = dict(zip(SHORT_ROWS, per_sm or (1,) * len(SHORT_ROWS)))
        short_rows = min((-(-(-(-S // (r // G)) * halves * K * B)
                            // (n_sm * max(1, occ[r]))), r)
                         for r in SHORT_ROWS if r >= G)[1]
    elif short_rows not in SHORT_ROWS or short_rows < G:
        raise ValueError(f"the short form holds {SHORT_ROWS} rows a CTA "
                         f"and a whole group of {G}: not {short_rows}")
    rows, bq = short_rows, short_rows // G
    return PrefillPlan(rows, keys, stages, bq, (-(-S // bq) * halves, K, B),
                       G, width, route, "short", halves)


def prefill_row(plan: PrefillPlan, S: int, G: int, x: int, kvh: int,
                r: int) -> Tuple[int, int] | None:
    """``(query, head)`` of row ``r`` of the CTA at ``x`` of the grid's
    first dim (in the kernel's order: query block ``x // plan.halves //
    n_slices``, head slice ``x // plan.halves % n_slices``; output half
    ``x % plan.halves``, :func:`prefill_cols`) and kv head ``kvh``, as the
    kernel computes it, or None for a row it leaves empty."""
    qb, hs = divmod(x // plan.halves, -(-G // plan.heads))
    s = qb * plan.bq + r // plan.heads
    gh = hs * plan.heads + r % plan.heads
    if r >= plan.bq * plan.heads or s >= S or gh >= G:
        return None
    return s, kvh * G + gh


def prefill_cols(plan: PrefillPlan, x: int, v_dim: int) -> Tuple[int, int]:
    """The output columns ``[lo, hi)`` the CTA at ``x`` of the grid's
    first dim writes of each of its rows: all ``v_dim`` of them, or, where
    ``plan.halves`` CTAs share a row (the short form at Dv 256), its
    half ``x % plan.halves``."""
    w = v_dim // plan.halves
    return x % plan.halves * w, x % plan.halves * w + w


def launch_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                lse: bool = False) -> PrefillPlan:
    """The :class:`PrefillPlan` :func:`chunked_attention` launches for
    CUDA tensors q (B,S,H,Dk), k (B,T,K,Dk), v (B,T,K,Dv) at S > 1 (with
    ``lse``: K3e's forward), on q's device's SM count."""
    B, S, H, D = q.shape
    T, Dv = k.shape[1], v.shape[-1]
    return prefill_plan(B, S, H, k.shape[2], D,
                        torch.float32 in (q.dtype, k.dtype), Dv, T=T,
                        n_sm=_device(q.device.index), lse=lse,
                        mixed=q.dtype != k.dtype,
                        per_sm=_short_per_sm(q.device.index, D, Dv,
                                             -(-T // PREFILL_KEYS)))


@functools.lru_cache(maxsize=None)
def _short_per_sm(index: int, D: int, Dv: int,
                  n_tiles: int) -> Optional[Tuple[int, ...]]:
    """The CTAs of the short form an SM of CUDA device ``index`` holds at
    each of :data:`SHORT_ROWS` rows a CTA (``n_tiles`` tiles of keys, at
    most :data:`SHORT_MAX_KEYS` keys' worth), as the card's occupancy
    calculator gives them; None at a (Dk, Dv) it has no instantiation of."""
    if (D, Dv) not in SHORT_DIMS:
        return None
    _device(index)                        # the shared-memory opt-in first
    n_tiles = min(n_tiles, SHORT_MAX_KEYS // PREFILL_KEYS)
    with torch.cuda.device(index):
        got = tuple(_lib().flash_prefill_short_per_sm(
            D, Dv, rows, n_tiles * PREFILL_KEYS) for rows in SHORT_ROWS)
    if min(got) < 1:
        raise RuntimeError(f"short-form occupancy query failed: {got}")
    return got


@functools.lru_cache(maxsize=None)
def _device(index: int) -> int:
    """The SM count of CUDA device ``index``; on the first call for a
    device, also the prefill kernel's shared-memory opt-in there."""
    with torch.cuda.device(index):
        err = _lib().flash_attention_prepare()
    if err:
        raise RuntimeError(f"attention kernel opt-in failed: error {err}")
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _wgmma_ready(index: int) -> ctypes.CDLL:
    """The all-bf16 prefill's library, after its shared-memory opt-in on
    CUDA device ``index`` (once a device)."""
    lib = _wgmma_lib()
    with torch.cuda.device(index):
        err = lib.flash_prefill_wgmma_prepare()
    if err:
        raise RuntimeError(f"wgmma prefill opt-in failed: error {err}")
    return lib


_WORKSPACE = {}


def _workspace(device: torch.device, stream: int, n_part: int,
               n_tickets: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode kernel's f32 partials and int32 tickets for one launch on
    ``stream``: kept per (device, stream) and grown on demand, since calls
    on one stream run in order.  Tickets start at 0, and the kernel leaves
    them at 0."""
    key = (device.index, stream)
    part, tickets = _WORKSPACE.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    _WORKSPACE[key] = part, tickets
    return part, tickets


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where it is contiguous and starts on a 16-byte
    boundary, else a contiguous copy (the kernels' vector loads need
    both)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      lse: Optional[torch.Tensor] = None,
                      out32: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 on the card.  q: (B,S,H,Dk), k: (B,T,K,Dk), v: (B,T,K,Dv),
    q_pos (B,S) and kv_pos (B,T) int32; key t is valid for query s iff
    kv_pos <= q_pos (causal) and kv_pos > q_pos - window (window > 0).  q
    and k/v may differ in dtype where Dk = Dv, k and v may not.  int8 k/v
    take ``k_scale``/``v_scale`` (B,T,K) f32 (K3d, decode only).  ``lse``,
    a contiguous (B,H,S) f32 tensor on the prefill route (S > 1) at Dk =
    Dv and a tile width up to 256 (the shapes ``backward_route`` gives the
    kernel), receives each row's log-sum-exp of its scaled scores, +inf
    for a row with no valid key (what K3e's backward reads); on the mma
    route's f32 path (an f32 operand) the scores are then summed to f32
    accuracy, and ``out32``, a contiguous (B,S,H,Dv) f32 tensor, may
    receive the output before its rounding to q's dtype.  Returns
    (B,S,H,Dv) in q's dtype."""
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
                    ("kv_pos", kv_pos), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if t is not None and not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if (q.dtype not in _DTYPES or k.dtype not in _KV_DTYPES
            or v.dtype != k.dtype):
        raise ValueError(f"q must be float32 or bfloat16 and k/v share "
                         f"float32, bfloat16 or int8 (got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}; ROADMAP Queue 2 K3g: "
                         f"float16 is not ported)")
    check_scales(k, k_scale, v_scale)
    B, S, H, D = q.shape
    T, K, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if (tuple(k.shape) != (B, T, K, D) or tuple(v.shape) != (B, T, K, Dv)
            or H % K or tuple(q_pos.shape) != (B, S)
            or tuple(kv_pos.shape) != (B, T)):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} q_pos {tuple(q_pos.shape)} "
                         f"kv_pos {tuple(kv_pos.shape)} do not fit "
                         f"(B,S,H,Dk) / (B,T,K,Dk) / (B,T,K,Dv) with "
                         f"H % K == 0")
    if (D, Dv) != MLA_DIMS and D != Dv:
        raise ValueError(f"head_dim {D} / {Dv}: the kernels take one head "
                         f"dim for q, k and v, or Dk 192 / Dv 128 in "
                         f"prefill")
    width = MLA_DIMS[0] if (D, Dv) == MLA_DIMS else tile_width(D)
    if D != Dv and S == 1:
        raise NotImplementedError(
            f"Dv != Dk ({D} / {Dv}) in decode (S = 1) is not ported: ROADMAP "
            f"Queue 2 K3c (MLA decodes through its absorbed einsums)")
    if D != Dv and q.dtype != k.dtype:
        raise ValueError(f"Dk {D} / Dv {Dv} takes q and k/v of one dtype "
                         f"(got {q.dtype} and {k.dtype})")
    int8 = k.dtype == torch.int8
    if int8 and S != 1:
        raise NotImplementedError(
            f"int8 K/V at S = {S} is not ported: ROADMAP Queue 2 K3d "
            f"(prefill; the reference cannot prefill an int8 cache)")
    if lse is not None and (S == 1 or width > 256 or D != Dv
                            or lse.dtype != torch.float32
                            or not lse.is_cuda or not lse.is_contiguous()
                            or tuple(lse.shape) != (B, H, S)):
        raise ValueError(f"lse takes a contiguous (B,H,S) = {(B, H, S)} "
                         f"float32 CUDA tensor on the prefill route at Dk = "
                         f"Dv, tile widths up to 256 (got "
                         f"{tuple(lse.shape)} {lse.dtype} {lse.device}, S "
                         f"{S}, head dims {D} / {Dv})")
    if out32 is not None and (
            lse is None or torch.float32 not in (q.dtype, k.dtype)
            or out32.dtype != torch.float32
            or not out32.is_cuda or not out32.is_contiguous()
            or tuple(out32.shape) != (B, S, H, Dv)):
        raise ValueError(f"out32 takes a contiguous (B,S,H,Dv) float32 "
                         f"CUDA tensor beside lse on the f32 path (got "
                         f"{tuple(out32.shape)} {out32.dtype}, q "
                         f"{q.dtype}, k/v {k.dtype})")
    n_sm = _device(q.device.index)
    if S == 1:
        gc, groups, n_split, split_len = decode_plan(
            B, K, H // K, T, k.element_size(), n_sm, D)
        if int8 and (q.dtype, D, gc) not in INT8_DECODE:
            raise ValueError(
                f"int8 K/V decode at q {q.dtype}, head_dim {D}, head group "
                f"{gc} (G {H // K}) is not instantiated: the kernel takes "
                f"{INT8_DECODE} (ROADMAP Queue 2 K3d)")
    q, k, v = (_aligned(t) for t in (q, k, v))
    if int8:
        k_scale = k_scale.to(torch.float32).contiguous()
        v_scale = v_scale.to(torch.float32).contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_pos = kv_pos.to(torch.int32).contiguous()
    out = q.new_empty((B, S, H, Dv))
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    if S == 1:
        part, tickets = _workspace(q.device, stream,
                                   B * H * n_split * (width + 2),
                                   B * K * groups)
        err = _decode_lib().flash_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if int8 else None,
            v_scale.data_ptr() if int8 else None, q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), B, T, H, K, D, width, int(causal),
            int(window), D ** -0.5, _DTYPES[q.dtype], _KV_DTYPES[k.dtype],
            gc, n_split, split_len, stream)
    else:
        plan = launch_plan(q, k, v, lse=lse is not None)
        if plan.route == "wgmma":
            err = _wgmma_ready(q.device.index).flash_prefill_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                kv_pos.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, S, T, H, K, D, Dv,
                int(causal), int(window), D ** -0.5, plan.width, plan.rows,
                plan.keys, plan.stages, plan.bq, plan.heads, plan.grid[0],
                stream)
        elif plan.form == "short":
            err = _lib().flash_prefill_short_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                kv_pos.data_ptr(), out.data_ptr(), B, S, T, H, K, D, Dv,
                int(causal), int(window), D ** -0.5, plan.rows, plan.keys,
                plan.stages, plan.halves, plan.bq, plan.grid[0], stream)
        else:
            err = _lib().flash_prefill_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                kv_pos.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                None if out32 is None else out32.data_ptr(), B, S, T, H, K, D,
                Dv, int(causal), int(window), D ** -0.5, _DTYPES[q.dtype],
                _DTYPES[k.dtype], plan.width, plan.rows, plan.keys,
                plan.stages, plan.bq, plan.heads, plan.grid[0], stream)
    if err:
        raise RuntimeError(f"attention kernel launch failed: error {err}")
    chunked_attention.launches += 1
    if S == 1:
        chunked_attention.decode += 1
        chunked_attention.decode_int8 += int8
    else:
        chunked_attention.prefill += 1
        chunked_attention.prefill_wgmma += plan.route == "wgmma"
        chunked_attention.prefill_short += plan.form == "short"
    return out


chunked_attention.launches = 0
chunked_attention.prefill = 0
chunked_attention.prefill_wgmma = 0
chunked_attention.prefill_short = 0
chunked_attention.decode = 0
chunked_attention.decode_int8 = 0
chunked_attention.backward = 0


# the tile widths K3e's backward kernel (csrc/flash_backward.cu) takes
BACKWARD_WIDTHS = (16, 32, 64, 96, 128, 256)


def backward_route(q_dtype: torch.dtype, kv_dtype: torch.dtype,
                   head_dim: int, v_dim: int) -> str:
    """How K3e's backward runs for a shape, decided before any launch:
    ``"kernel"`` (csrc/flash_backward.cu) where Dk = Dv has a tile width of
    :data:`BACKWARD_WIDTHS` (every head dim that is a multiple of 8 up to
    256, q and k/v float32 or bfloat16 in any pair); ``"recompute"`` (the
    plain chunked twin differentiated under autograd, counted in
    ``TrainAttention.backward_plain``) at tile width 512 and at MLA's Dk
    192 / Dv 128, ROADMAP Queue 2's part of K3e still to port.  No training
    path reaches the recompute.  Raises ``ValueError`` for head dims the
    forward does not take."""
    prefill_route(q_dtype, kv_dtype, head_dim, v_dim)
    if head_dim == v_dim and tile_width(head_dim) in BACKWARD_WIDTHS:
        return "kernel"
    return "recompute"


@functools.lru_cache(maxsize=None)
def _backward_ready(index: int) -> ctypes.CDLL:
    """The backward's library, after its shared-memory opt-in on CUDA
    device ``index`` (once a device)."""
    lib = _backward_lib()
    with torch.cuda.device(index):
        err = lib.flash_backward_prepare()
    if err:
        raise RuntimeError(f"attention backward opt-in failed: error {err}")
    return lib


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, lse: torch.Tensor,
                       dout: torch.Tensor, q_pos: torch.Tensor,
                       kv_pos: torch.Tensor, *, causal: bool = True,
                       window: int = 0, out32: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3e's backward on the card: (dq, dk, dv) of :func:`chunked_attention`
    at q (B,S,H,D), k/v (B,T,K,D), whose launch wrote ``out`` and ``lse``
    (and, for bf16 q over f32 K/V, ``out32``: Delta then reads the output
    before its rounding to bf16), for the upstream gradient ``dout``
    (B,S,H,D).  One call launches, from csrc/flash_backward.cu, the prep
    kernel (Delta = rowsum(dout * out), q scaled in its own dtype), for
    f32 q over bf16 K/V two widening kernels (K and V to f32), then one
    gradients kernel, whose grid holds the dK/dV blocks and the dQ blocks,
    all on q's device's current stream, and counts one in
    ``chunked_attention.backward``.  dq comes in
    q's dtype, dk and dv in K/V's.  Raises on a shape
    :func:`backward_route` does not give the kernel, and if a launch
    reports an error."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if backward_route(q.dtype, k.dtype, D, v.shape[-1]) != "kernel":
        raise ValueError(f"head dims {D} / {v.shape[-1]}: the backward "
                         f"kernel takes Dk = Dv at tile widths "
                         f"{BACKWARD_WIDTHS}")
    if (tuple(out.shape) != (B, S, H, D) or tuple(dout.shape) != (B, S, H, D)
            or tuple(lse.shape) != (B, H, S) or lse.dtype != torch.float32
            or out.dtype != q.dtype or dout.dtype != q.dtype):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype}, dout "
                         f"{tuple(dout.shape)} {dout.dtype} and lse "
                         f"{tuple(lse.shape)} {lse.dtype} do not fit q "
                         f"{tuple(q.shape)} {q.dtype}")
    if (out32 is not None) != (q.dtype == torch.bfloat16
                               and k.dtype == torch.float32):
        raise ValueError("out32 comes with bf16 q over f32 K/V, and only "
                         "there")
    q, k, v, out, dout, lse = (_aligned(t) for t in (q, k, v, out, dout, lse))
    if out32 is not None:
        out32 = _aligned(out32)
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_pos = kv_pos.to(torch.int32).contiguous()
    bf16 = q.dtype == k.dtype == torch.bfloat16
    work = torch.bfloat16 if bf16 else torch.float32
    qs = torch.empty(q.shape, dtype=work, device=q.device)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    do_f32 = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
              if q.dtype == torch.bfloat16 and not bf16 else None)
    kv_f32 = ([torch.empty(k.shape, dtype=torch.float32, device=q.device)
               for _ in range(2)]
              if k.dtype == torch.bfloat16 and not bf16 else [None, None])
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    ptr = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    err = _backward_ready(q.device.index).flash_backward_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ptr(out32), dout.data_ptr(), lse.data_ptr(), q_pos.data_ptr(),
        kv_pos.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), qs.data_ptr(),
        delta.data_ptr(), ptr(do_f32), ptr(kv_f32[0]), ptr(kv_f32[1]), B, S,
        T, H, K, D, int(causal), int(window), D ** -0.5, _DTYPES[q.dtype],
        _DTYPES[k.dtype], tile_width(D), stream)
    if err:
        raise RuntimeError(f"attention backward launch failed: error {err}")
    chunked_attention.backward += 1
    return dq, dk, dv


class TrainAttention(torch.autograd.Function):
    """K3e: K3's prefill kernel under autograd, the reference's
    ``kernels/ops.py::_flash_vjp`` (:20-44).  Where :func:`backward_route`
    gives the kernel, the forward launches the prefill through
    :func:`chunked_attention` (counted on its prefill route) with an ``lse``
    buffer (and, for bf16 q over f32 K/V, an f32 copy of the output
    before its rounding) and saves q, k, v, the output, the log-sum-exp
    and the positions; the backward makes the upstream gradient contiguous and
    launches :func:`attention_backward` (counted in
    ``chunked_attention.backward``), which reads them.  On the recompute
    route (tile width 512, MLA's Dk 192 / Dv 128) the forward saves the
    caller's q, k, v and positions, and the backward differentiates the
    plain chunked twin (``ref.chunked_attention_ref``, as the reference's
    ``_flash_bwd`` differentiates its jnp oracle) under autograd, counted in
    ``TrainAttention.backward_plain``."""

    backward_plain = 0

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window, block):
        ctx.mask = (causal, window, block)
        ctx.route = backward_route(q.dtype, k.dtype, q.shape[-1],
                                   v.shape[-1])
        if ctx.route == "recompute":
            ctx.save_for_backward(q, k, v, q_pos, kv_pos)
            return chunked_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                     window=window)
        B, S, H, D = q.shape
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        out32 = (torch.empty((B, S, H, D), dtype=torch.float32,
                             device=q.device)
                 if q.dtype == torch.bfloat16 and k.dtype == torch.float32
                 else None)
        out = chunked_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                window=window, lse=lse, out32=out32)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, kv_pos, out32)
        return out

    @staticmethod
    def backward(ctx, g):
        causal, window, block = ctx.mask
        if ctx.route == "kernel":
            q, k, v, out, lse, q_pos, kv_pos, out32 = ctx.saved_tensors
            grads = attention_backward(q, k, v, out, lse, g.contiguous(),
                                       q_pos, kv_pos, causal=causal,
                                       window=window, out32=out32)
            return (*grads, None, None, None, None, None)
        from repro_torch.kernels import ref

        q, k, v, q_pos, kv_pos = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = ref.chunked_attention_ref(*leaves, q_pos, kv_pos,
                                            causal=causal, window=window,
                                            block=block)
            grads = torch.autograd.grad(out, leaves, g)
        TrainAttention.backward_plain += 1
        return (*grads, None, None, None, None, None)


def train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block: int = 512) -> torch.Tensor:
    """K3 where q, k or v requires grad (K3e), on CUDA tensors; ``block``
    is the plain KV chunk of the recompute route (:func:`backward_route`).  Decode (S = 1) and int8 K/V raise
    ``NotImplementedError``: no path trains through them."""
    if q.shape[1] == 1:
        raise NotImplementedError(
            "attention under autograd at S = 1 (decode) is not ported: "
            "K3e runs the prefill kernel, and no path trains a decode step")
    if k.dtype == torch.int8:
        raise NotImplementedError(
            "attention under autograd over int8 K/V is not ported: int8 "
            "K/V are a decode cache's, which no path trains")
    return TrainAttention.apply(q, k, v, q_pos, kv_pos, causal, window,
                                block)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,H,S,D); k/v: (B,K,T,D).  Returns (B,H,S,D)."""
    from repro_torch.kernels import ops

    B, H, S, D = q.shape
    T = k.shape[2]
    q_pos = (torch.arange(S, dtype=torch.int32, device=q.device)
             + (T - S)).expand(B, S)
    kv_pos = torch.arange(T, dtype=torch.int32, device=q.device).expand(B, T)
    out = ops.chunked_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), q_pos, kv_pos,
                                causal=causal, window=window)
    return out.transpose(1, 2)
