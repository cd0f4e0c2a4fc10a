"""The port's single-device training against the reference: AdamW, its
schedule and global norm, gradient compression, the data pipeline, the
train step, checkpoints across packages and the launcher.

Bars (f32 on the CPU, reduced models, so the two frameworks differ only in
summation order): the optimiser's and the compressor's outputs within
rtol 1e-6 of the reference's on shared inputs, compression's int8 codes
equal; step 1's ce, aux, zloss and loss within 1e-5 (relative) and its
gradients and first moments within 1e-5 of each leaf's largest (at least
1e-7); the updated params within 1e-5 where the gradient is above 1e-6
(Adam's first step is lr * g / (|g| + 1e-8): a gradient near that eps
moves it anywhere within lr, which bounds every weight); losses over 10
steps within 2e-5, and after a checkpoint taken by the reference, within
2e-5 too.  The
port's data stream draws with torch, not jax.random, so its batches are
held to the reference's recipe and determinism, and the parity runs feed
the reference's batches."""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro.checkpoint import manager as R_ckpt
from repro.configs import get_reduced
from repro.core.lisa import compression as R_comp
from repro.data import pipeline as R_data
from repro.launch.mesh import make_local_mesh
from repro.optim import adamw as R_opt
from repro.train import step as R_step
from repro_torch.core.lisa import compression as P_comp
from repro_torch.data import pipeline as P_data
from repro_torch.launch import train as P_launch
from repro_torch.optim import adamw as P_opt
from repro_torch.train import step as P_step
from repro_torch.weights import params_from_jax

RTOL = 1e-6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves_with_path(rtree, ptree):
    """(path, reference leaf, port leaf) for every leaf of the reference."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(rtree)[0]:
        node = ptree
        for k in path:
            node = node[k.key]
        yield "/".join(str(k.key) for k in path), np.asarray(leaf), node


# ------------------------------------------------------------ optimiser ---

def _opt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32),
              "blk": {"u": rng.normal(size=(2, 3, 4)).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32) * 3, params) for _ in range(3)]
    return params, grads


def test_adamw_matches_the_reference():
    """Three updates with clipping engaged, decay on the >= 2-d leaves
    only, warmup then cosine: params, moments, count and metrics."""
    params, grads = _opt_inputs()
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=1.0)
    rp, rs = jax.tree.map(jnp.asarray, params), R_opt.init(params)
    pp = P_opt.tree_map(torch.from_numpy, params)
    ps = P_opt.init(pp)
    for g in grads:
        rp, rs, rm = R_opt.update(R_opt.OptConfig(**ocfg),
                                  jax.tree.map(jnp.asarray, g), rs, rp)
        pp, ps, pm = P_opt.update(P_opt.OptConfig(**ocfg),
                                  P_opt.tree_map(torch.from_numpy, g), ps,
                                  pp)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(pm[key].numpy(), np.asarray(rm[key]),
                                       rtol=RTOL)
        for rt, pt in ((rp, pp), (rs.m, ps.m), (rs.v, ps.v)):
            for path, r, p in _leaves_with_path(rt, pt):
                np.testing.assert_allclose(p.numpy(), r, rtol=RTOL,
                                           atol=1e-7, err_msg=path)
        assert int(ps.count) == int(rs.count)
    assert float(pm["grad_norm"]) > 1.0          # clipping engaged


@pytest.mark.parametrize("step", [0, 1, 5, 10, 37, 100, 150])
def test_schedule_matches_the_reference(step):
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = float(R_opt.schedule(R_opt.OptConfig(**cfg), jnp.int32(step)))
    got = float(P_opt.schedule(P_opt.OptConfig(**cfg),
                               torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=RTOL, abs=1e-7)


def test_global_norm_and_tree_order():
    params, grads = _opt_inputs(1)
    want = float(R_opt.global_norm(jax.tree.map(jnp.asarray, grads[0])))
    got = float(P_opt.global_norm(P_opt.tree_map(torch.from_numpy,
                                                 grads[0])))
    assert got == pytest.approx(want, rel=RTOL)
    assert float(P_opt.global_norm({"a": torch.ones(4)})) == 2.0
    order = [a.shape for a in P_opt.tree_leaves(
        P_opt.tree_map(torch.from_numpy, params))]
    assert order == [a.shape for a in jax.tree.leaves(params)]


# ---------------------------------------------------------- compression ---

def test_compression_matches_the_reference():
    rng = np.random.default_rng(2)
    g = rng.normal(size=(64, 33)).astype(np.float32)
    e = rng.normal(size=(64, 33)).astype(np.float32) * 0.01
    rq, rs, re = R_comp.compress(jnp.asarray(g), jnp.asarray(e))
    pq, ps, pe = P_comp.compress(torch.from_numpy(g), torch.from_numpy(e))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    assert pq.dtype == torch.int8
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), rtol=RTOL)
    np.testing.assert_allclose(pe.numpy(), np.asarray(re), rtol=RTOL,
                               atol=1e-8)
    np.testing.assert_allclose(P_comp.decompress(pq, ps).numpy(),
                               np.asarray(R_comp.decompress(rq, rs)),
                               rtol=RTOL)
    err = P_comp.init_error({"a": torch.ones(3, 2), "b": {"c": torch.ones(4)}})
    assert err["a"].shape == (3, 2) and float(err["b"]["c"].abs().sum()) == 0


def test_compression_rounds_half_to_even():
    """A target of max 127 has scale 1, so its codes are round(target):
    halves go to the even neighbour in both frameworks."""
    t = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5], np.float32)
    zero = np.zeros_like(t)
    rq = np.asarray(R_comp.compress(jnp.asarray(t), jnp.asarray(zero))[0])
    pq = P_comp.compress(torch.from_numpy(t), torch.from_numpy(zero))[0]
    assert pq.tolist() == [127, 0, 2, 2, 0, -2, 4] == rq.tolist()


# ----------------------------------------------------------------- data ---

def test_batch_at_is_deterministic_and_keeps_the_recipe():
    dcfg = P_data.DataConfig(vocab_size=100, seq_len=40, global_batch=8,
                             seed=3)
    b1 = P_data.batch_at(dcfg, 5, device="cpu")
    b2 = P_data.batch_at(dcfg, 5, device="cpu")
    assert all(torch.equal(b1[k], b2[k]) for k in b1)
    assert not torch.equal(P_data.batch_at(dcfg, 6, device="cpu")["tokens"],
                           b1["tokens"])
    other = P_data.DataConfig(vocab_size=100, seq_len=40, global_batch=8,
                              seed=4)
    assert not torch.equal(P_data.batch_at(other, 5, device="cpu")["tokens"],
                           b1["tokens"])
    t = b1["tokens"]
    assert t.dtype == torch.int32 and t.shape == (8, 40)
    assert torch.equal(b1["labels"][:, :-1], t[:, 1:])
    assert torch.equal(b1["labels"][:, -1], t[:, 0])
    # the copy task: a token equals the one repeat_len before it but where
    # noise (5%) replaced one of the two
    same = float((t[:, 16:] == t[:, :-16]).float().mean())
    assert 0.85 < same < 0.95
    assert int(t.min()) >= 0 and int(t.max()) < 100


def test_host_shard_slices_as_the_reference():
    rb = R_data.batch_at(R_data.DataConfig(vocab_size=50, seq_len=8,
                                           global_batch=8, seed=1), 2)
    pb = {k: torch.from_numpy(np.asarray(v)) for k, v in rb.items()}
    for h in range(4):
        want = R_data.host_shard(rb, h, 4)
        got = P_data.host_shard(pb, h, 4)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


# ----------------------------------------------------------- train step ---

RECIPE = dict(lr=8e-3, warmup_steps=2, total_steps=40)


@functools.lru_cache(maxsize=None)
def _ref_setup(arch, grad_compress=False):
    """The reference's config, ParallelConfig, step-0 state, compiled step
    and DataConfig (compiled once a module: the state is immutable)."""
    cfg = get_reduced(arch)
    pcfg = R_step.ParallelConfig(fsdp=False, grad_compress=grad_compress)
    state = R_step.init_train_state(cfg, jax.random.key(0), pcfg)
    _, compile_step, _ = R_step.make_train_step(
        cfg, make_local_mesh(1, 1), pcfg, R_opt.OptConfig(**RECIPE),
        donate=False)
    dcfg = R_data.DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                             global_batch=4, repeat_len=8)
    b0 = R_data.batch_at(dcfg, 0)
    shapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                          (state, b0))
    return cfg, pcfg, state, compile_step(*shapes), dcfg


def _port_batch(rbatch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in rbatch.items()}


@pytest.fixture(scope="module", params=["tinyllama-1.1b", "olmoe-1b-7b"])
def parity(request):
    """The reference's state and step for a reduced config, and the
    port's state over the same params."""
    cfg, pcfg, rstate, rstep, dcfg = _ref_setup(request.param)
    pparams = params_from_jax(_np_tree(rstate.params), device="cpu")
    ppcfg = P_step.ParallelConfig(fsdp=False)
    pstate = P_step.state_from_params(pparams, ppcfg)
    pstep = P_step.make_train_step(cfg, ppcfg, P_opt.OptConfig(**RECIPE))
    return cfg, pcfg, rstate, rstep, dcfg, ppcfg, pstate, pstep


def test_step_one_matches_the_reference(parity):
    """Step 1: ce, aux, zloss and loss; every gradient against jax.grad's;
    the updated params and moments."""
    cfg, pcfg, rstate, rstep, dcfg, ppcfg, pstate, pstep = parity
    rb = R_data.batch_at(dcfg, 0)
    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        lambda p: R_step.loss_fn(cfg, pcfg, p, rb), has_aux=True))(
            rstate.params)
    ploss, pmet, pgrads = P_step.grads_of(cfg, ppcfg, pstate.params,
                                          _port_batch(rb))
    assert float(ploss) == pytest.approx(float(rloss), rel=1e-5)
    for key in ("ce", "aux", "zloss"):
        assert float(pmet[key]) == pytest.approx(float(rmet[key]), rel=1e-5,
                                                 abs=1e-7), key
    if cfg.family == "moe":
        assert float(pmet["aux"]) > 0
    for path, r, p in _leaves_with_path(rgrads, pgrads):
        bar = max(1e-5 * float(np.abs(r).max()), 1e-7)
        np.testing.assert_allclose(p.numpy(), r, rtol=0, atol=bar,
                                   err_msg=path)
    r1, rm = rstep(rstate, rb)
    p1, pm = pstep(pstate, _port_batch(rb))
    assert float(pm["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert float(pm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                   rel=1e-5)
    _same_update(r1, p1, rgrads)
    assert int(p1.step) == 1 and int(p1.opt.count) == 1
    # the step left its input as it was
    assert int(pstate.step) == 0 and float(
        P_opt.global_norm(pstate.opt.m)) == 0.0


def _same_update(r1, p1, rgrads):
    """Step 1's params and first moments against the reference's.  The
    moments are the clipped gradients times 0.1: within 1e-5 of the
    largest, as the gradients.  Adam's first step moves a weight by lr * g
    / (|g| + eps): within 1e-5 where |g| > 1e-6, but where a gradient is
    near eps its rounding can move the step anywhere within lr (8e-3)."""
    grads = {path: np.abs(g)
             for path, g, _ in _leaves_with_path(rgrads, p1.params)}
    for path, r, p in _leaves_with_path(r1.params, p1.params):
        diff = np.abs(p.numpy() - r)
        assert (diff[grads[path] > 1e-6] <= 1e-5).all(), path
        assert (diff <= RECIPE["lr"]).all(), path
    for path, r, p in _leaves_with_path(r1.opt.m, p1.opt.m):
        np.testing.assert_allclose(p.numpy(), r, rtol=0,
                                   atol=max(1e-5 * float(np.abs(r).max()),
                                            1e-9), err_msg=path)


def test_ten_steps_match_the_reference(parity):
    cfg, pcfg, rstate, rstep, dcfg, ppcfg, pstate, pstep = parity
    for i in range(10):
        rb = R_data.batch_at(dcfg, i)
        rstate, rm = rstep(rstate, rb)
        pstate, pm = pstep(pstate, _port_batch(rb))
        assert abs(float(pm["loss"]) - float(rm["loss"])) < 2e-5, i


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """A TrainState the reference saved at step 3 restores into the port
    and continues to the reference's losses for steps 3-6."""
    cfg, pcfg, rstate, rstep, dcfg = _ref_setup("tinyllama-1.1b")
    s = rstate
    for i in range(3):
        s, _ = rstep(s, R_data.batch_at(dcfg, i))
    R_ckpt.save(s, str(tmp_path), 3)
    want = []
    for i in range(3, 7):
        s, m = rstep(s, R_data.batch_at(dcfg, i))
        want.append(float(m["loss"]))
    like = P_step.state_from_params(
        params_from_jax(_np_tree(rstate.params), device="cpu"),
        P_step.ParallelConfig(fsdp=False))
    from repro_torch.checkpoint import manager as P_ckpt
    ps = P_ckpt.restore(like, str(tmp_path), device="cpu")
    assert int(ps.step) == 3 and int(ps.opt.count) == 3
    pstep = P_step.make_train_step(cfg, P_step.ParallelConfig(fsdp=False),
                                   P_opt.OptConfig(**RECIPE))
    for i, w in zip(range(3, 7), want):
        ps, m = pstep(ps, _port_batch(R_data.batch_at(dcfg, i)))
        assert abs(float(m["loss"]) - w) < 2e-5, i


# ------------------------------------------- the reference's behaviours ---

def _port_setup(grad_compress=False, total=40):
    cfg = get_reduced("tinyllama-1.1b")
    pcfg = P_step.ParallelConfig(fsdp=False, grad_compress=grad_compress)
    state = P_step.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    pcfg, device="cpu")
    step = P_step.make_train_step(cfg, pcfg, P_opt.OptConfig(
        lr=8e-3, warmup_steps=2, total_steps=total))
    dcfg = P_data.DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                             global_batch=4, repeat_len=8)
    return state, step, dcfg


def test_loss_decreases():
    """test_train_loop.py::test_loss_decreases on the port."""
    state, step, dcfg = _port_setup()
    losses = []
    for s in range(40):
        state, m = step(state, P_data.batch_at(dcfg, s, device="cpu"))
        losses.append(float(m["ce"]))
    assert np.mean(losses[-4:]) < np.mean(losses[:4]) - 0.15, losses


def test_resume_is_bitexact(tmp_path):
    """test_train_loop.py::test_resume_is_bitexact on the port (its own
    checkpoint manager, the reference's format)."""
    from repro_torch.checkpoint import manager as P_ckpt
    state, step, dcfg = _port_setup()
    s = state
    for i in range(3):
        s, _ = step(s, P_data.batch_at(dcfg, i, device="cpu"))
    P_ckpt.save(s, str(tmp_path), 3)
    ref = s
    for i in range(3, 6):
        ref, _ = step(ref, P_data.batch_at(dcfg, i, device="cpu"))
    resumed = P_ckpt.restore(state, str(tmp_path), device="cpu")
    for i in range(3, 6):
        resumed, _ = step(resumed, P_data.batch_at(dcfg, i, device="cpu"))
    for a, b in zip(P_opt.tree_leaves(ref.params),
                    P_opt.tree_leaves(resumed.params)):
        assert torch.equal(a, b)


def test_grad_compression_training_still_learns():
    """test_train_loop.py::test_grad_compression_training_still_learns on
    the port."""
    state, step, dcfg = _port_setup(grad_compress=True, total=32)
    assert state.err_fb is not None
    losses = []
    for s in range(32):
        state, m = step(state, P_data.batch_at(dcfg, s, device="cpu"))
        losses.append(float(m["ce"]))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.15, losses
    assert float(P_opt.global_norm(state.err_fb)) > 0


def test_grad_compression_step_matches_the_reference():
    """One compressed step from shared params and batch: the error
    feedback and the updated params as the reference's."""
    cfg, pcfg, rstate, rstep, dcfg = _ref_setup("tinyllama-1.1b",
                                                grad_compress=True)
    ppcfg = P_step.ParallelConfig(fsdp=False, grad_compress=True)
    ps = P_step.state_from_params(
        params_from_jax(_np_tree(rstate.params), device="cpu"), ppcfg)
    pstep = P_step.make_train_step(cfg, ppcfg, P_opt.OptConfig(**RECIPE))
    rb = R_data.batch_at(dcfg, 0)
    rgrads = jax.jit(jax.grad(lambda p: R_step.loss_fn(cfg, pcfg, p,
                                                       rb)[0]))(rstate.params)
    r1, rm = rstep(rstate, rb)
    p1, pm = pstep(ps, _port_batch(rb))
    assert float(pm["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    # the params move by Adam's first step of the decompressed gradient:
    # within 1e-5 but where a code moved (below), there within lr
    for path, r, p in _leaves_with_path(r1.params, p1.params):
        diff = np.abs(p.numpy() - r)
        assert (diff > 1e-5).sum() <= max(1, 1e-4 * r.size), path
        assert (diff <= RECIPE["lr"]).all(), path
    # the residual g - q * scale moves with the gradient (within 1e-5 of
    # its largest, as step 1's gradients) but where a code sits at a
    # rounding boundary: there the code moves by one and the residual by a
    # step (scale = max|g| / 127); at most 1e-4 of a leaf's codes do
    for (path, r, p), (_, g, _) in zip(
            _leaves_with_path(r1.err_fb, p1.err_fb),
            _leaves_with_path(rgrads, p1.err_fb)):
        bar = max(1e-5 * float(np.abs(g).max()), 1e-9)
        flips = np.abs(p.numpy() - r) > bar
        assert flips.sum() <= max(1, 1e-4 * r.size), path


def test_mesh_knobs_raise():
    cfg = get_reduced("tinyllama-1.1b")
    with pytest.raises(NotImplementedError, match="item 16"):
        P_step.make_train_step(cfg, P_step.ParallelConfig(moe_groups=2))


# ------------------------------------------------------------- launcher ---

ARGV = ["--device", "cpu", "--arch", "tinyllama-1.1b", "--reduced",
        "--steps", "6", "--batch", "2", "--seq", "32", "--log-every", "3"]


def test_launcher_runs_resumes_and_refuses_a_mesh(tmp_path, monkeypatch):
    """The launcher's run, the same run checkpointed at step 3 and stopped
    right after that save, then resumed: the resumed run's losses and final
    params equal the uninterrupted run's.  ``--data 2`` and ``--model 2``
    raise."""
    from repro_torch.checkpoint import manager as P_ckpt
    res, state, hist = P_launch.run(ARGV)
    assert res["steps"] == 6 and res["last_loss"] == hist["losses"][-1]
    assert all(np.isfinite(hist["grad_norms"]))

    class Crash(Exception):
        pass

    real = P_ckpt.save

    def save_then_crash(tree, d, step, keep_last=3):
        real(tree, d, step, keep_last)
        raise Crash

    ck = str(tmp_path / "ck")
    monkeypatch.setattr(P_ckpt, "save", save_then_crash)
    with pytest.raises(Crash):
        P_launch.run(ARGV + ["--ckpt-dir", ck, "--ckpt-every", "3"])
    monkeypatch.setattr(P_ckpt, "save", real)
    assert P_ckpt.latest_step(ck) == 3
    res2, state2, hist2 = P_launch.run(ARGV + ["--ckpt-dir", ck])
    assert res2["steps"] == 3 and hist2["losses"] == hist["losses"][3:]
    assert res2["last_loss"] == res["last_loss"]
    for a, b in zip(P_opt.tree_leaves(state.params),
                    P_opt.tree_leaves(state2.params)):
        assert torch.equal(a, b)
    for flag in ("--data", "--model"):
        with pytest.raises(NotImplementedError, match="item 16"):
            P_launch.main(ARGV + [flag, "2"])


def test_launcher_as_a_module_prints_the_reference_json(tmp_path):
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGV[:-2],
         "--steps", "2", "--grad-compress"], capture_output=True, text=True,
        check=True, timeout=300, env={**os.environ, "PYTHONPATH": src})
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(last) == {"first_loss", "last_loss", "steps", "seconds"}
    assert last["steps"] == 2 and np.isfinite(last["last_loss"])


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P_launch.main(ARGV[2:])
