"""Enc-dec cross attention (seamless-m4t-medium) against the reference: the
port's ``cross_block``, ``encode_kv`` and ``_encode``, and reduced
seamless's ``forward`` with frame embeddings and its ``prefill`` +
``decode_step`` path (the reference's own enc-dec serving path,
tests/test_decode_consistency.py::test_encdec_prefill_then_decode), from
the reference's weights (``params_from_jax``), f32 throughout.

BAR is ROADMAP's f32 parity bar: the two frameworks compute the same f32
steps in another order of summation, which at these widths moves the
outputs (logits of magnitude ~3.5) by a few 1e-6.  Greedy tokens must be
equal.  The reference's own bar between decode and the cacheless forward
is 1e-4, relative to the largest logit.

Also: the Engine refuses an enc-dec config at construction (the
reference's cannot prefill one: its insert calls ``lm.prefill`` without
frame embeddings and fails with an ``AttributeError``), the launcher with
it, and a prefill whose frame count is not the cache's ``enc_len`` raises
(the port writes its caches in place)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs import get_reduced
from repro.models import attention as RA
from repro.models import lm as R_lm
from repro.serve.engine import Engine as REngine
from repro.serve.engine import Request as RRequest
from repro_torch.launch.serve import main as p_main
from repro_torch.models import attention as PA
from repro_torch.models import lm as P_lm
from repro_torch.serve.engine import Engine as PEngine
from repro_torch.weights import params_from_jax

BAR = 3e-5
ARCH = "seamless-m4t-medium"
B, T, MAX_LEN = 2, 6, 16


@pytest.fixture(scope="module")
def model():
    cfg = get_reduced(ARCH)
    rparams = R_lm.init_lm(cfg, jax.random.key(3))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    return cfg, rparams, pparams


def _close(p, r, bar=BAR, what=""):
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), rtol=0,
                               atol=bar, err_msg=what)


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def _frames(cfg, seed, n=T, batch=B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n, cfg.d_model)) * 0.02
            ).astype(np.float32)


def _tokens(cfg, seed, S, batch=B):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, S)).astype(np.int32)


def _layer0(tree):
    return jax.tree.map(lambda t: t[0], tree)


# ---- parameters and caches -------------------------------------------------

def test_params_from_jax_carries_the_encdec_leaves(model):
    """Every leaf of the reference's tree, the encoder stage, enc_norm and
    each decoder block's cross block and ln_cross among them, crosses bit
    for bit; the port's own init_lm has the same leaves, shapes and
    dtypes."""
    cfg, rparams, pparams = model
    own = P_lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(rparams)[0]
    names = {"/".join(k.key for k in path) for path, _ in flat}
    assert {"encoder/b0/mixer/wq", "enc_norm", "stage0/b0/cross/wo",
            "stage0/b0/ln_cross"} <= names
    for path, leaf in flat:
        for tree in (pparams, own):
            node = tree
            for k in path:
                node = node[k.key]
            assert tuple(node.shape) == leaf.shape
            assert str(node.dtype) == f"torch.{leaf.dtype}"
        node = pparams
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert len(flat) == sum(1 for _ in _leaves(own))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_init_cache_enc_leaves_match_reference(model):
    cfg = model[0]
    rc = R_lm.init_cache(cfg, B, max_len=MAX_LEN, enc_len=T)
    pc = P_lm.init_cache(cfg, B, MAX_LEN, enc_len=T, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(rc)[0]
    assert any(path[-1].key == "enc_pos" for path, _ in flat)
    for path, leaf in flat:
        node = pc
        for k in path:
            node = node[k.key]
        assert str(node.dtype) == f"torch.{leaf.dtype}"
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


# ---- the blocks ------------------------------------------------------------

@pytest.mark.parametrize("mask", ["none", "pads", "all-pad-row"])
def test_cross_block_matches_reference(model, mask):
    """Queries at 2**29 over frames at 0, or at 2**30 where the encoder
    mask has a pad: ragged pads, and a batch row with no valid frame
    (its output is 0 in both)."""
    cfg, rparams, pparams = model
    rng = np.random.default_rng(11)
    S, Te = 5, 40              # Te > the kernel twin's 32-key tiles
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    kv = [rng.standard_normal((B, Te, cfg.n_heads, cfg.head_dim)
                              ).astype(np.float32) for _ in range(2)]
    m = None
    if mask != "none":
        m = np.ones((B, Te), bool)
        m[0, 33:] = False
        m[1, ::3] = False
        if mask == "all-pad-row":
            m[1] = False
    rp = _layer0(rparams["stage0"]["b0"]["cross"])
    pp = {k: v[0] for k, v in pparams["stage0"]["b0"]["cross"].items()}
    want = RA.cross_block(rp, jnp.asarray(x), tuple(map(jnp.asarray, kv)),
                          None if m is None else jnp.asarray(m),
                          n_heads=cfg.n_heads, head_dim=cfg.head_dim)
    got = PA.cross_block(pp, torch.from_numpy(x),
                         tuple(map(torch.from_numpy, kv)),
                         None if m is None else torch.from_numpy(m),
                         n_heads=cfg.n_heads, head_dim=cfg.head_dim)
    _close(got, want)
    if mask == "all-pad-row":
        assert not got[1].any()


def test_encode_kv_and_encoder_match_reference(model):
    cfg, rparams, pparams = model
    enc_r, enc_p = _pair(_frames(cfg, 5, n=37))
    rp = _layer0(rparams["stage0"]["b0"]["cross"])
    pp = {k: v[0] for k, v in pparams["stage0"]["b0"]["cross"].items()}
    for got, want in zip(
            PA.encode_kv(pp, enc_p, cfg.n_heads, cfg.head_dim),
            RA.encode_kv(rp, enc_r, cfg.n_heads, cfg.head_dim)):
        _close(got, want)
    # bidirectional: every frame sees every other, at 37 frames (> the
    # twin's 32-key tiles)
    _close(P_lm._encode(cfg, pparams, enc_p),
           R_lm._encode(cfg, rparams, enc_r))


def test_noncausal_block_pads_follow_the_twin_not_pallas():
    """At causal=False over T = 37 keys in 32-key blocks, the reference's
    ``chunked_attention`` also attends the zero keys it pads its last
    block with, and the port's plain twin (the CPU path) does as it does;
    the reference's Pallas kernel masks them (its kv padding), as K3 does
    on the card, which equals the twin with one block holding every key
    (tests/test_torch_cuda.py::test_encoder_on_card_masks_block_pads_as_pallas).
    No full-size path meets this: seamless's 4096 frames are eight of its
    512-key blocks."""
    from repro.kernels.flash_attention import flash_attention as r_pallas
    from repro_torch.kernels import ref as P_ref

    rng = np.random.default_rng(12)
    B, T, H, D = 2, 37, 4, 16
    q, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32)
               for _ in range(3))
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    jq, jk, jv, jp = map(jnp.asarray, (q, k, v, pos))
    tq, tk, tv, tp = map(torch.from_numpy, (q, k, v, pos))
    twin = RA.chunked_attention(jq, jk, jv, jp, jp, causal=False, block=32)
    pallas = r_pallas(*(x.swapaxes(1, 2) for x in (jq, jk, jv)),
                      causal=False, block_q=32, block_k=32,
                      interpret=True).swapaxes(1, 2)
    _close(P_ref.chunked_attention_ref(tq, tk, tv, tp, tp, causal=False,
                                       block=32), twin)
    _close(P_ref.chunked_attention_ref(tq, tk, tv, tp, tp, causal=False,
                                       block=64), pallas)
    assert float(jnp.abs(twin - pallas).max()) > 1e-2


# ---- the model -------------------------------------------------------------

def test_forward_with_enc_embeds_matches_reference(model):
    cfg, rparams, pparams = model
    toks_r, toks_p = _pair(_tokens(cfg, 4, 9))
    enc_r, enc_p = _pair(_frames(cfg, 5))
    want, _, _ = R_lm.forward(cfg, rparams, toks_r, enc_embeds=enc_r)
    got, aux, _ = P_lm.forward(cfg, pparams, toks_p, enc_embeds=enc_p)
    _close(got, want)
    np.testing.assert_array_equal(got.numpy().argmax(-1),
                                  np.asarray(want).argmax(-1))
    assert float(aux) == 0.0


def test_prefill_then_decode_step_match_reference(model):
    """init_cache(enc_len=T), prefill of 4 tokens with the frames, then
    teacher-forced decode_steps to 12: logits and caches (the cross K/V
    and their positions, and the self-attention K/V) against the
    reference's, and the port's decode against its own cacheless forward
    within the reference's 1e-4 bar."""
    cfg, rparams, pparams = model
    S, P = 12, 4
    toks = _tokens(cfg, 4, S)
    enc_r, enc_p = _pair(_frames(cfg, 5))
    rc = R_lm.init_cache(cfg, B, max_len=MAX_LEN, enc_len=T)
    pc = P_lm.init_cache(cfg, B, MAX_LEN, enc_len=T, device="cpu")
    rlog, rc = R_lm.prefill(cfg, rparams, jnp.asarray(toks[:, :P]), rc,
                            enc_embeds=enc_r)
    plog, _ = P_lm.prefill(cfg, pparams, torch.from_numpy(toks[:, :P]), pc,
                           enc_embeds=enc_p)
    _close(plog, rlog, what="prefill logits")
    r_step = jax.jit(partial(R_lm.decode_step, cfg))
    outs = [plog[:, -1]]
    for t in range(P, S):
        rlog, rc = r_step(rparams, rc, jnp.asarray(toks[:, t:t + 1]),
                          jnp.int32(t))
        plog, _ = P_lm.decode_step(cfg, pparams, pc,
                                   torch.from_numpy(toks[:, t:t + 1]), t)
        _close(plog, rlog, what=f"step {t}")
        np.testing.assert_array_equal(plog.numpy().argmax(-1),
                                      np.asarray(rlog).argmax(-1))
        outs.append(plog[:, 0])
    for st in rc:
        for b, r in rc[st].items():
            p = pc[st][b]
            np.testing.assert_array_equal(p["enc_pos"].numpy(),
                                          np.asarray(r["enc_pos"]))
            assert not p["enc_pos"].any()           # every frame valid
            np.testing.assert_array_equal(p["pos"].numpy(),
                                          np.asarray(r["pos"]))
            valid = np.asarray(r["pos"]) < 2**30
            for name in ("enc_k", "enc_v"):
                _close(p[name], r[name], what=name)
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    p[name].numpy()[valid], np.asarray(r[name])[valid],
                    rtol=0, atol=BAR, err_msg=name)
    full, _, _ = P_lm.forward(cfg, pparams, torch.from_numpy(toks),
                              enc_embeds=enc_p)
    dec = torch.stack(outs, 1)
    err = float((dec - full[:, P - 1:]).abs().max() / full.abs().max())
    assert err < 1e-4


def test_decode_reads_the_cache_not_the_frames(model):
    """Decode attends over the prefilled cross K/V: overwriting one
    layer's cached enc_v changes the decode logits, and restoring it
    restores them bit for bit."""
    cfg, _, pparams = model
    toks = torch.from_numpy(_tokens(cfg, 6, 5))
    pc = P_lm.init_cache(cfg, B, MAX_LEN, enc_len=T, device="cpu")
    P_lm.prefill(cfg, pparams, toks[:, :4], pc,
                 enc_embeds=torch.from_numpy(_frames(cfg, 7)))
    keep = {k: v.clone() for k, v in pc["stage0"]["b0"].items()}
    a, _ = P_lm.decode_step(cfg, pparams, pc, toks[:, 4:5], 4)
    pc["stage0"]["b0"]["enc_v"][-1].mul_(3.0)
    b, _ = P_lm.decode_step(cfg, pparams, pc, toks[:, 4:5], 4)
    assert not torch.equal(a, b)
    for k, v in keep.items():
        pc["stage0"]["b0"][k].copy_(v)
    c, _ = P_lm.decode_step(cfg, pparams, pc, toks[:, 4:5], 4)
    assert torch.equal(a, c)


def test_prefill_into_a_slot_keeps_the_other_rows(model):
    """A batch-1 prefill into slot 1 writes that row's cross K/V and
    positions only; row 0 keeps its init values (zeros, 2**30)."""
    cfg, _, pparams = model
    pc = P_lm.init_cache(cfg, B, MAX_LEN, enc_len=T, device="cpu")
    P_lm.prefill(cfg, pparams, torch.from_numpy(_tokens(cfg, 8, 3, 1)), pc,
                 enc_embeds=torch.from_numpy(_frames(cfg, 9, batch=1)),
                 slot=1)
    c = pc["stage0"]["b0"]
    assert (c["enc_pos"][:, 0] == 2**30).all() and not c["enc_pos"][:, 1].any()
    assert not c["enc_k"][:, 0].any() and c["enc_k"][:, 1].any()
    P_lm.reset_slot(pc, 1)
    assert (c["enc_pos"] == 2**30).all() and not c["enc_k"].any()


def test_enc_len_and_missing_frames_raise(model):
    cfg, _, pparams = model
    toks = torch.from_numpy(_tokens(cfg, 4, 4))
    pc = P_lm.init_cache(cfg, B, MAX_LEN, enc_len=T, device="cpu")
    with pytest.raises(ValueError, match=r"7 frames.*enc_len=6"):
        P_lm.prefill(cfg, pparams, toks, pc,
                     enc_embeds=torch.from_numpy(_frames(cfg, 5, n=7)))
    with pytest.raises(ValueError, match="enc_embeds"):
        P_lm.forward(cfg, pparams, toks)


# ---- serving ---------------------------------------------------------------

def test_engine_refuses_encdec_as_the_reference_cannot_prefill(model):
    cfg, rparams, pparams = model
    with pytest.raises(NotImplementedError, match="enc_embeds"):
        PEngine(cfg, pparams, slots=2, max_len=32, device="cpu")
    ref = REngine(cfg, rparams, slots=2, max_len=32, n_sessions=4)
    with pytest.raises(AttributeError):
        ref.submit(RRequest(0, np.arange(5, dtype=np.int32), 4))


def test_launcher_refuses_encdec():
    with pytest.raises(NotImplementedError, match="enc-dec"):
        p_main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--requests", "2"])
