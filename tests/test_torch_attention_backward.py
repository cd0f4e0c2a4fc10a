"""K3e's backward kernel's algorithm, on the CPU, against the reference.

The CUDA kernel (``csrc/flash_backward.cu``) computes dQ, dK and dV from
the forward's output and its row log-sum-exp.  ``ref.attention_backward_ref``
repeats its algorithm in plain PyTorch (Delta = rowsum(dO o O), P = exp(S -
lse) per key block, dK/dV summed over the group's heads, dQ over the key
blocks, every product through the 3xTF32 split of ``ref._tc_dot``), and
``ref.prefill_lse_ref`` gives the log-sum-exp the prefill kernels write.
On numpy inputs from a seed they are held to:

- ``jax.vjp`` of the reference's ``kernels.ops.flash_attention`` in
  interpret mode, whose backward (``_flash_bwd``) differentiates the exact
  ``flash_attention_ref``: q rows at the tail of the keys, no pads, among
  them non-causal attention over T = 600 keys, where the port's chunked
  twin counts its block padding as keys (the old recompute's gradient, not
  its forward's) and the kernel's algorithm does not;
- ``jax.vjp`` of the reference's ``models.attention.chunked_attention``
  with per-row positions: ragged 2**30 pads, S != T, windows, rows with no
  valid key (their gradients 0), at T <= 512 (one block, where the two
  agree).

Gradients are held within TOL of the largest reference gradient of their
tensor (3e-5 in f32, 2e-2 in bf16: tests/test_kernels.py's bars); a single
TF32 pass (``split=False``) misses the f32 bar.  Also ``backward_route``'s
table: which shapes the kernel takes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro.kernels import ops as R_ops
from repro.models import attention as RA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as P_ref

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
SENTINEL = 2**30


def _pair(x, name):
    """The same values as a jax and a torch array of dtype ``name``."""
    t = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, name))
    return jnp.asarray(t.float().numpy()).astype(jnp.dtype(name)), t


def _gap(got, want) -> float:
    """Largest gap of ``got`` to ``want`` over the largest |want|."""
    w = np.asarray(want.astype(jnp.float32), np.float64)
    g = got.float().numpy().astype(np.float64)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _inputs(seed, B, S, T, H, K, D, name):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, D), (B, T, K, D), (B, T, K, D),
                          (B, S, H, D))]
    return [_pair(a, name) for a in arrs]


def _port(q, k, v, dout, q_pos, kv_pos, *, causal, window, split=True):
    """The port's forward (the plain twin), the kernel's log-sum-exp and
    the kernel's backward, all plain."""
    out = P_ref.chunked_attention_ref(q, k, v, q_pos, kv_pos, causal=causal,
                                      window=window, block=max(
                                          8, k.shape[1]))
    lse = P_ref.prefill_lse_ref(q, k, q_pos, kv_pos, causal=causal,
                                window=window)
    grads = P_ref.attention_backward_ref(q, k, v, out, lse, dout, q_pos,
                                         kv_pos, causal=causal,
                                         window=window, split=split)
    return out, lse, grads


def _chunked_vjp(rq, rk, rv, rdo, q_pos, kv_pos, *, causal, window):
    """The reference's chunked_attention and its vjp at per-row
    positions."""
    qp, kp = jnp.asarray(q_pos.numpy()), jnp.asarray(kv_pos.numpy())

    def f(q, k, v):
        return RA.chunked_attention(q, k, v, qp, kp, causal=causal,
                                    window=window, block=512)

    out, vjp = jax.vjp(f, rq, rk, rv)
    return out, vjp(rdo)


def _flash_vjp(rq, rk, rv, rdo, *, causal, window):
    """The reference's Pallas kernel (interpret mode) and its vjp, whose
    backward differentiates flash_attention_ref; (B,S,H,D) in and out."""
    def f(q, k, v):
        o = R_ops.flash_attention(q.transpose(0, 2, 1, 3),
                                  k.transpose(0, 2, 1, 3),
                                  v.transpose(0, 2, 1, 3), causal=causal,
                                  window=window, interpret=True)
        return o.transpose(0, 2, 1, 3)

    out, vjp = jax.vjp(f, rq, rk, rv)
    return out, vjp(rdo)


def _ref_lse(rq, rk, q_pos, kv_pos, *, causal, window):
    """The reference's log-sum-exp of its scaled scores, in f32."""
    B, S, H, D = rq.shape
    K = rk.shape[2]
    qs = (rq.reshape(B, S, K, H // K, D) * D ** -0.5).astype(jnp.float32)
    s = jnp.einsum("bskgd,btkd->bkgst", qs, rk.astype(jnp.float32))
    qp = jnp.asarray(q_pos.numpy())[:, None, None, :, None]
    kp = jnp.asarray(kv_pos.numpy())[:, None, None, None, :]
    valid = jnp.ones(s.shape, bool)
    if causal:
        valid &= kp <= qp
    if window > 0:
        valid &= kp > qp - window
    s = jnp.where(valid, s, -jnp.inf)
    return np.asarray(jax.nn.logsumexp(s, -1)).reshape(B, H, S)


def _tail_positions(B, S, T):
    q_pos = (torch.arange(S, dtype=torch.int32) + (T - S)).expand(B, S)
    kv_pos = torch.arange(T, dtype=torch.int32).expand(B, T)
    return q_pos.contiguous(), kv_pos.contiguous()


# B, S, T, H, K, D, causal, window
FLASH_CASES = [
    (2, 40, 40, 8, 8, 64, True, 0),       # G 1
    (2, 40, 40, 8, 2, 64, True, 0),       # G 4
    (1, 48, 48, 16, 2, 16, True, 0),      # G 8, head dim 16
    (2, 33, 33, 8, 2, 72, True, 12),      # a window, head dim 72
    (1, 24, 56, 8, 1, 128, True, 0),      # S != T at the tail, G 8
    (2, 30, 30, 4, 4, 64, False, 0),      # non-causal
    (1, 20, 20, 4, 1, 224, True, 0),      # head dim 224
]


@pytest.mark.parametrize("B,S,T,H,K,D,causal,window", FLASH_CASES)
def test_backward_ref_matches_flash_vjp(B, S, T, H, K, D, causal, window):
    """dq, dk and dv of the kernel's algorithm against the reference
    Pallas kernel's vjp (flash_attention_ref's exact gradients)."""
    (rq, q), (rk, k), (rv, v), (rdo, do) = _inputs(D + S, B, S, T, H, K, D,
                                                   "float32")
    q_pos, kv_pos = _tail_positions(B, S, T)
    _, want = _flash_vjp(rq, rk, rv, rdo, causal=causal, window=window)
    _, _, got = _port(q, k, v, do, q_pos, kv_pos, causal=causal,
                      window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _gap(g, w) < TOL["float32"]


def test_backward_ref_non_causal_past_one_block_is_exact():
    """Non-causal over T = 600 keys (not a multiple of the twin's 512-key
    block): the kernel's algorithm gives flash_attention_ref's gradients,
    while differentiating the port's chunked twin (the old recompute) does
    not: its last block's 424 padded keys at 2**30 pass a non-causal mask
    and take weight.  The reference's chunked_attention pads the same way,
    so the exact function here is the Pallas kernel's."""
    B, S, T, H, K, D = 1, 600, 600, 2, 1, 32
    (rq, q), (rk, k), (rv, v), (rdo, do) = _inputs(600, B, S, T, H, K, D,
                                                   "float32")
    q_pos, kv_pos = _tail_positions(B, S, T)
    want_out, want = _flash_vjp(rq, rk, rv, rdo, causal=False, window=0)
    out, _, got = _port(q, k, v, do, q_pos, kv_pos, causal=False, window=0)
    assert _gap(out, want_out) < TOL["float32"]
    for g, w in zip(got, want):
        assert _gap(g, w) < TOL["float32"]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    old = P_ref.chunked_attention_ref(*leaves, q_pos, kv_pos, causal=False,
                                      block=512)
    stale = torch.autograd.grad(old, leaves, do)
    assert max(_gap(g, w) for g, w in zip(stale, want)) > 100 * TOL[
        "float32"]


def _ragged(B, S, T, seed):
    """Per-row positions: row b's queries at the tail of its own valid
    length, its last slots empty (2**30), the first row's first query
    before every key (no valid key), S != T."""
    rng = np.random.default_rng(seed)
    q_pos = np.zeros((B, S), np.int32)
    kv_pos = np.full((B, T), SENTINEL, np.int32)
    for b in range(B):
        n = int(rng.integers(S + 1, T + 1))            # valid keys
        kv_pos[b, :n] = np.arange(n) + 3
        q_pos[b] = np.arange(S) + 3 + n - S
    q_pos[0, 0] = 1                                    # sees no key
    return torch.from_numpy(q_pos), torch.from_numpy(kv_pos)


# B, S, T, H, K, D, causal, window, dtype
CHUNKED_CASES = [
    (3, 17, 50, 8, 8, 64, True, 0, "float32"),        # G 1, S != T, pads
    (2, 24, 61, 8, 2, 16, True, 0, "float32"),        # G 4
    (2, 20, 45, 16, 2, 72, True, 9, "float32"),       # G 8, a window
    (2, 30, 40, 4, 1, 128, True, 16, "float32"),
    (2, 16, 33, 8, 2, 224, True, 0, "float32"),
    (2, 20, 37, 4, 2, 64, False, 0, "float32"),       # non-causal, pads
    (2, 24, 61, 8, 2, 64, True, 0, "bfloat16"),
    (2, 20, 45, 16, 2, 128, True, 9, "bfloat16"),
]


@pytest.mark.parametrize("B,S,T,H,K,D,causal,window,name", CHUNKED_CASES)
def test_backward_ref_matches_chunked_vjp(B, S, T, H, K, D, causal, window,
                                          name):
    """The kernel's algorithm against jax.vjp of the reference's
    chunked_attention at per-row positions (ragged pads, S != T, a row that
    sees no key), and its log-sum-exp against the reference scores'."""
    (rq, q), (rk, k), (rv, v), (rdo, do) = _inputs(D + T, B, S, T, H, K, D,
                                                   name)
    q_pos, kv_pos = _ragged(B, S, T, D + S)
    want_out, want = _chunked_vjp(rq, rk, rv, rdo, q_pos, kv_pos,
                                  causal=causal, window=window)
    out, lse, got = _port(q, k, v, do, q_pos, kv_pos, causal=causal,
                          window=window)
    assert _gap(out, want_out) < TOL[name]
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert bool(torch.isfinite(g.float()).all())
        assert _gap(g, w) < TOL[name]
    if name == "float32":
        ref_lse = _ref_lse(rq, rk, q_pos, kv_pos, causal=causal,
                           window=window)
        seen = np.isfinite(ref_lse)
        assert np.array_equal(np.isinf(lse.numpy()), ~seen)
        assert float(np.abs(lse.numpy()[seen] - ref_lse[seen]).max()) < 3e-5
    if causal:
        # the first row's first query sees no key: no gradient, no NaN
        assert not got[0][0, 0].float().any()
        assert bool(torch.isinf(lse[0, :, 0]).all())


def test_backward_ref_all_rows_without_keys():
    """A batch row whose keys are all empty slots (2**30) under a causal
    mask: its lse is +inf and every gradient of it 0, finite."""
    B, S, T, H, K, D = 2, 12, 20, 4, 2, 32
    (_, q), (_, k), (_, v), (_, do) = _inputs(5, B, S, T, H, K, D,
                                              "float32")
    q_pos, kv_pos = _tail_positions(B, S, T)
    kv_pos = kv_pos.clone()
    kv_pos[1] = SENTINEL
    _, lse, (dq, dk, dv) = _port(q, k, v, do, q_pos, kv_pos, causal=True,
                                 window=0)
    assert bool(torch.isinf(lse[1]).all()) and bool(lse[0].isfinite().all())
    for g in (dq, dk, dv):
        assert bool(torch.isfinite(g).all()) and not g[1].any()
        assert g[0].abs().max() > 0


def test_single_tf32_pass_misses_the_bar():
    """Without the 3xTF32 split the gradients miss the f32 bar: the
    kernel splits every product."""
    B, S, T, H, K, D = 1, 64, 64, 8, 2, 64
    (rq, q), (rk, k), (rv, v), (rdo, do) = _inputs(7, B, S, T, H, K, D,
                                                   "float32")
    q_pos, kv_pos = _tail_positions(B, S, T)
    _, want = _chunked_vjp(rq, rk, rv, rdo, q_pos, kv_pos, causal=True,
                           window=0)
    _, _, split = _port(q, k, v, do, q_pos, kv_pos, causal=True, window=0)
    _, _, single = _port(q, k, v, do, q_pos, kv_pos, causal=True, window=0,
                         split=False)
    assert max(_gap(g, w) for g, w in zip(split, want)) < TOL["float32"]
    assert max(_gap(g, w) for g, w in zip(single, want)) > TOL["float32"]


@pytest.mark.parametrize("D,Dv,route", [
    (16, 16, "kernel"), (32, 32, "kernel"), (64, 64, "kernel"),
    (72, 72, "kernel"), (96, 96, "kernel"), (128, 128, "kernel"),
    (224, 224, "kernel"), (256, 256, "kernel"), (264, 264, "recompute"),
    (512, 512, "recompute"), (192, 128, "recompute")])
def test_backward_route_table(D, Dv, route):
    """Every head dim the forward takes up to 256 takes the backward
    kernel in every dtype pair; width 512 and MLA's 192 / 128 keep the
    recompute (ROADMAP Queue 2)."""
    pairs = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
             (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.bfloat16)]
    if D != Dv:
        pairs = [pairs[0], pairs[3]]
    for qdt, kvdt in pairs:
        assert FA.backward_route(qdt, kvdt, D, Dv) == route


def test_backward_route_refuses_what_the_forward_refuses():
    with pytest.raises(ValueError):
        FA.backward_route(torch.float32, torch.float32, 520, 520)
    with pytest.raises(ValueError):
        FA.backward_route(torch.float32, torch.float32, 64, 32)


def test_twin_grads_f64_is_the_exact_gradient():
    """``ref.twin_grads_f64``, the f64 standard the card holds the kernel's
    gradients to, is the Pallas kernel's exact gradient (its f64 run
    within the f32 bar of the reference's f32 vjp) and comes out in f64;
    ``ref.rel_l2`` is relative, and absolute against zeros."""
    B, S, T, H, K, D = 2, 40, 40, 8, 2, 64
    (rq, q), (rk, k), (rv, v), (rdo, do) = _inputs(11, B, S, T, H, K, D,
                                                   "float32")
    q_pos, kv_pos = _tail_positions(B, S, T)
    _, want = _flash_vjp(rq, rk, rv, rdo, causal=True, window=0)
    got = P_ref.twin_grads_f64(q, k, v, q_pos, kv_pos, do)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert _gap(g, w) < TOL["float32"]
    x = torch.tensor([3.0, 4.0])
    assert P_ref.rel_l2(x * 1.5, x) == pytest.approx(0.5)
    assert P_ref.rel_l2(x, torch.zeros(2)) == pytest.approx(5.0)
