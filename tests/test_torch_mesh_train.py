"""The port's mesh training step against its own single-device step, on
stacked meshes on the CPU and on 4 gloo ranks; the two-axis mesh; the
counts of hops and reductions a step; MoE over a split batch; the elastic
example.

Bars: loss and grad norm within rel 1e-5 of the single-device step's (the
two differ in the order of their sums: each device's loss over its batch
slice, the gradient's reduce-scatter and the norm's psum), step 1's params
within 1e-5 where the gradient is above 1e-6 and within lr everywhere
(``test_torch_train._same_update``); with grad compression, at most 1e-4 of
a leaf's params past 1e-5 (a code at a rounding boundary moves by one).
The gloo ranks and the stack run the same program on the same inputs:
bit-equal.
"""
import math

import numpy as np
import pytest
import torch

from _torch_ranks import MESH_TRAIN_STEPS, run_gloo, run_stacked
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.checkpoint import manager as P_ckpt
from repro_torch.configs import get_reduced
from repro_torch.examples import elastic_rescale
from repro_torch.launch.mesh import StackedAxis, make_local_mesh
from repro_torch.models import lm
from repro_torch.models import sharding as SHD
from repro_torch.optim import adamw as P_opt
from repro_torch.train import shardings as SH
from repro_torch.train import step as TS

RECIPE = dict(lr=8e-3, warmup_steps=2, total_steps=40)
BATCH, SEQ = 8, 32


def _batches(cfg, n, seed=0):
    """``n`` batches of numpy-drawn tokens, labels the next token."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
        out.append({"tokens": torch.from_numpy(t[:, :-1].copy()),
                    "labels": torch.from_numpy(t[:, 1:].copy())})
    return out


def _params(cfg, seed=0):
    return lm.init_lm(cfg, torch.Generator().manual_seed(seed),
                      device="cpu")


def step_counts(params, shardings, mesh, batch_axes, pcfg, cfg):
    """{axis: (hops, reductions)} of one mesh step, from the step's rule:
    a leaf's all-gather makes n hops on each axis it is split over of n
    devices, but along a model split the compute shares
    (``shardings.compute_dim``), which it keeps; its gradient's
    reduce-scatter n - 1 more on an axis whose devices hold shares of it
    (a batch axis; the model axis with tensor_parallel for a leaf each
    device of a model group uses whole, where a leaf the compute splits
    otherwise than its storage is cut after the gather and its slices'
    gradients all-gathered over the model axis, a reduction); a leaf whole
    along such an axis
    is all-reduced over it (2n - 1 hops); a stacked layer leaf does all of
    that once a rep (``step.Reps``), but along a split of its reps dim,
    gathered once; the clip's norm reduces once on
    each axis a leaf is split over, grad compression's scale once more;
    the metrics once on each batch axis; the split compute's collectives
    (:func:`split_reductions`) on the model axis."""
    sizes = mesh.shape
    tp = pcfg.tensor_parallel and sizes["model"] > 1
    hops = {a: 0 for a in sizes}
    red = {a: 0 for a in sizes}
    with SHD.use_sharding(mesh, TS.sharding_rules(pcfg),
                          batch_axes=batch_axes):
        for (path, x), (_, sh) in zip(P_ckpt._flatten(params),
                                      P_ckpt._flatten(shardings)):
            split = [a for a in sh.axes() if sizes[a] > 1]
            cd = SH.compute_dim(path.split("/"), x.shape, cfg)
            keep = cd is not None and dict(sh.dims()).get(cd) == ("model",)
            sums = tuple(batch_axes) + (("model",) if tp and cd is None
                                        else ())
            reps = x.shape[0] if path.startswith("stage") else 1
            lead = dict(sh.dims()).get(0, ()) if reps > 1 else ()
            if tp and cd is not None and not keep:
                red["model"] += reps  # model_slice's backward all-gather
            for a in split:
                red[a] += 2 if pcfg.grad_compress else 1
                if not (keep and a == "model"):
                    hops[a] += (1 if a in lead else reps) * (
                        sizes[a] + (sizes[a] - 1 if a in sums else 0))
            for a in sums:
                if a not in split:
                    hops[a] += reps * (2 * sizes[a] - 1)
    for a in batch_axes:
        red[a] += 1
    if tp:
        red["model"] += split_reductions(cfg, sizes["model"],
                                         pcfg.sequence_parallel)
    return {a: (hops[a], red[a]) for a in sizes}


def split_reductions(cfg, m, sp):
    """The model axis's collectives in one step of a dense GQA model's
    split compute, forward and backward: each partial output's reduction
    (the embedding where the vocab splits, every attention and MLP block
    where its heads or ff split), under sequence parallelism each block
    input's all-gather and the final norm's; the cross entropy's pmax and
    its two psums where the vocab splits (the pmax has no backward)."""
    vs = cfg.vocab_size % m == 0
    block = ((2 if cfg.n_heads % m == 0 else 0)
             + (2 if cfg.d_ff % m == 0 else 0) + (4 if sp else 0))
    return ((2 if vs else 0) + cfg.n_layers * block + (2 if sp else 0)
            + (5 if vs else 0))


def _same_update(p1, s1, grads, lr, compressed=False):
    for (path, r), (_, p), (_, g) in zip(P_ckpt._flatten(s1.params),
                                         P_ckpt._flatten(p1.params),
                                         P_ckpt._flatten(grads)):
        diff = (p - r).abs()
        if compressed:
            assert (diff > 1e-5).sum() <= max(1, 1e-4 * r.numel()), path
        else:
            assert (diff[g.abs() > 1e-6] <= 1e-5).all(), path
        assert (diff <= lr).all(), path


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


CASES = [  # (data, model, tensor_parallel, fsdp, grad_compress)
    (4, 1, True, True, False),
    (2, 2, True, True, False),
    (4, 2, True, True, False),
    (2, 2, False, True, False),
    (4, 2, False, True, False),
    (2, 2, True, False, False),
    (4, 2, False, False, False),
    (2, 2, True, True, True),
    (4, 2, False, True, True),
]


@pytest.mark.parametrize("data,model,tp,fsdp,gc", CASES)
def test_mesh_step_matches_the_single_device_step(data, model, tp, fsdp, gc):
    """Two steps of reduced tinyllama on a stacked mesh against the
    single-device step; each step's hops and reductions equal
    :func:`step_counts`."""
    cfg = get_reduced("tinyllama-1.1b")
    pcfg = TS.ParallelConfig(fsdp=fsdp, tensor_parallel=tp, grad_compress=gc)
    ocfg = P_opt.OptConfig(**RECIPE)
    state = TS.state_from_params(_params(cfg), pcfg)
    batches = _batches(cfg, 2)
    single = TS.make_train_step(cfg, pcfg, ocfg)
    mesh = make_local_mesh(data, model, device="cpu")
    _, compile_step, state_shardings = TS.make_train_step(cfg, mesh, pcfg,
                                                          ocfg)
    sh = state_shardings(state)
    step = compile_step(state, batches[0])
    dp = ("data",) if tp else ("data", "model")
    want = step_counts(state.params, sh.params, mesh,
                       tuple(a for a in dp if mesh.shape[a] > 1), pcfg, cfg)
    st, s1 = SH.shard(state, sh), state
    for i, b in enumerate(batches):
        mesh.reset_counts()
        st, m = step(st, b)
        assert mesh.counts() == want, i
        if i == 0:
            grads = TS.grads_of(cfg, pcfg, s1.params, b)[2]
        s1, m1 = single(s1, b)
        assert _rel(m["loss"], m1["loss"]) <= 1e-5, i
        assert _rel(m["grad_norm"], m1["grad_norm"]) <= 1e-5, i
        assert float(m["lr"]) == float(m1["lr"])
        if i == 0:
            _same_update(SH.unshard(st, sh), s1, grads, RECIPE["lr"], gc)
    full = SH.unshard(st, sh)
    assert int(full.step) == 2 and int(full.opt.count) == 2
    if gc:
        assert float(P_opt.global_norm(full.err_fb)) > 0


def test_rwkv_mesh_step_matches_the_single_device_step():
    """A recurrent family, separable over the batch: reduced rwkv6-7b on a
    2 x 2 mesh, one step."""
    cfg = get_reduced("rwkv6-7b")
    pcfg = TS.ParallelConfig(fsdp=True)
    state = TS.state_from_params(_params(cfg, 1), pcfg)
    b = _batches(cfg, 1, seed=1)[0]
    mesh = make_local_mesh(2, 2, device="cpu")
    _, compile_step, state_shardings = TS.make_train_step(
        cfg, mesh, pcfg, P_opt.OptConfig(**RECIPE))
    sh = state_shardings(state)
    assert any(s.axes() for _, s in P_ckpt._flatten(sh.params))
    st, m = compile_step(state, b)(SH.shard(state, sh), b)
    grads = TS.grads_of(cfg, pcfg, state.params, b)[2]
    s1, m1 = TS.make_train_step(cfg, pcfg, P_opt.OptConfig(**RECIPE))(
        state, b)
    assert _rel(m["loss"], m1["loss"]) <= 1e-5
    assert _rel(m["grad_norm"], m1["grad_norm"]) <= 1e-5
    _same_update(SH.unshard(st, sh), s1, grads, RECIPE["lr"])


def test_moe_runs_where_the_batch_is_whole_and_refuses_a_split():
    """An MoE layer routes over the global batch: reduced olmoe on a 1 x 2
    mesh (tensor_parallel: the batch stays whole, experts over model)
    matches the single device; so do the meshes that split the batch
    (2 x 1, and 1 x 2 without tensor_parallel: the batch over model),
    whose routing groups span the devices, and ``moe_groups`` 2 (once
    refused, ROADMAP item 16c)."""
    cfg = get_reduced("olmoe-1b-7b")
    b = _batches(cfg, 1, seed=2)[0]
    for shape, kw in (((1, 2), {}), ((2, 1), {}),
                      ((1, 2), {"tensor_parallel": False}),
                      ((2, 2), {"moe_groups": 2})):
        pcfg = TS.ParallelConfig(fsdp=True, **kw)
        state = TS.state_from_params(_params(cfg, 2), pcfg)
        mesh = make_local_mesh(*shape, device="cpu")
        _, compile_step, state_shardings = TS.make_train_step(cfg, mesh,
                                                              pcfg)
        st, m = compile_step(state, b)(
            SH.shard(state, state_shardings(state)), b)
        _, m1 = TS.make_train_step(cfg, pcfg)(state, b)
        assert _rel(m["loss"], m1["loss"]) <= 1e-5, (shape, kw)
        assert _rel(m["aux"], m1["aux"]) <= 1e-5, (shape, kw)
        assert _rel(m["grad_norm"], m1["grad_norm"]) <= 1e-5, (shape, kw)
        assert float(m["aux"]) > 0


def test_a_donated_state_is_updated_in_place():
    """``donate=True`` (the reference's keyword): the compiled step writes
    the new params and moments into the laid-out state it was given, and
    its numbers are the undonated step's, bit for bit."""
    cfg = get_reduced("tinyllama-1.1b")
    pcfg = TS.ParallelConfig(sequence_parallel=True)
    state = TS.state_from_params(_params(cfg), pcfg)
    b = _batches(cfg, 1)[0]
    mesh = make_local_mesh(2, 2, device="cpu")
    runs = []
    for donate in (False, True):
        _, compile_step, state_shardings = TS.make_train_step(
            cfg, mesh, pcfg, P_opt.OptConfig(**RECIPE), donate=donate)
        laid = SH.shard(state, state_shardings(state))
        ptrs = [t.data_ptr() for t in P_opt.tree_leaves(laid.params)]
        new, m = compile_step(state, b)(laid, b)
        same = [t.data_ptr() for t in P_opt.tree_leaves(new.params)] == ptrs
        assert same == donate
        runs.append((new, m))
    (a, ma), (c, mc) = runs
    assert float(ma["loss"]) == float(mc["loss"])
    for (path, x), (_, y) in zip(P_ckpt._flatten(a), P_ckpt._flatten(c)):
        assert torch.equal(x, y), path


def test_step_refuses_a_state_not_laid_out():
    cfg = get_reduced("tinyllama-1.1b")
    pcfg = TS.ParallelConfig()
    state = TS.state_from_params(_params(cfg), pcfg)
    b = _batches(cfg, 1)[0]
    _, compile_step, _ = TS.make_train_step(
        cfg, make_local_mesh(2, 2, device="cpu"), pcfg)
    with pytest.raises(ValueError, match="laid out"):
        compile_step(state, b)(state, b)


def test_step_fn_steps_a_full_state():
    """The first of the three values steps a full state, as the
    reference's step_fn does a global one."""
    cfg = get_reduced("tinyllama-1.1b")
    pcfg = TS.ParallelConfig()
    state = TS.state_from_params(_params(cfg), pcfg)
    b = _batches(cfg, 1)[0]
    step_fn, _, _ = TS.make_train_step(
        cfg, make_local_mesh(2, 2, device="cpu"), pcfg)
    s2, m = step_fn(state, b)
    _, m1 = TS.make_train_step(cfg, pcfg)(state, b)
    assert _rel(m["loss"], m1["loss"]) <= 1e-5
    for (p, a), (_, c) in zip(P_ckpt._flatten(s2), P_ckpt._flatten(state)):
        assert a.shape == c.shape, p


# ------------------------------------------------------ the 2-axis mesh ---

def test_two_axis_stacked_mesh():
    """make_local_mesh(2, 3): the reference's device order, each axis's
    index, a hop inside every group at once (one gather over the stack),
    psum/pmax within each group, and 16-byte-off shards staged."""
    mesh = make_local_mesh(2, 3, device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 2, "model": 3}
    assert mesh.devices.tolist() == [[0, 1, 2], [3, 4, 5]]
    data, model = mesh.axis("data"), mesh.axis("model")
    assert data.index().tolist() == [0, 0, 0, 1, 1, 1]
    assert model.index().tolist() == [0, 1, 2, 0, 1, 2]
    x = torch.arange(6 * 5, dtype=torch.float32).reshape(6, 5)   # 20 B
    got = model.ppermute(x, [(0, 1), (1, 2)])
    want = torch.zeros_like(x)
    want[[1, 2, 4, 5]] = x[[0, 1, 3, 4]]
    assert torch.equal(got, want)
    assert torch.equal(data.ppermute(x, [(0, 1), (1, 0)]),
                       x[[3, 4, 5, 0, 1, 2]])
    assert torch.equal(data.psum(x), (x[:3] + x[3:]).repeat(2, 1))
    assert torch.equal(model.pmax(x), x.view(2, 3, 5).amax(1, keepdim=True)
                       .expand(2, 3, 5).reshape(6, 5))
    assert mesh.counts() == {"data": (1, 1), "model": (1, 1)}
    mesh.reset_counts()
    assert mesh.counts() == {"data": (0, 0), "model": (0, 0)}
    # the single axis keeps its behaviour
    one = StackedAxis(4, device="cpu")
    assert one.n_local == 4 and one.positions == (0, 1, 2, 3)


def test_ranks_mesh_refuses_another_world_size(monkeypatch):
    from repro_torch.launch.mesh import Mesh
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="takes 4 ranks"):
        Mesh.from_env(2, 2, device="cpu")


# ------------------------------------------------------------ the ranks ---

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ranks")
    cfg = get_reduced("tinyllama-1.1b")
    shared = {f"param/{p}": l.numpy()
              for p, l in P_ckpt._flatten(_params(cfg, 5))}
    for i, b in enumerate(_batches(cfg, MESH_TRAIN_STEPS, seed=5)):
        shared.update({f"{k}@{i}": v.numpy() for k, v in b.items()})
    gdir = tmp / "gloo"
    gdir.mkdir()
    gloo = run_gloo(["mesh_train"], 4, {"x": np.zeros((4, 1), np.float32)},
                    {**shared, "ckpt_dir": str(tmp / "ck_gloo")}, gdir)
    stacked = run_stacked("mesh_train", 4, {"x": np.zeros((4, 1),
                                                          np.float32)},
                          {**shared, "ckpt_dir": str(tmp / "ck_stack")})
    return gloo["mesh_train"], stacked, shared, tmp


def test_ranks_equal_the_stack_bit_for_bit(ranks):
    """The 2 x 2 mesh on 4 gloo ranks (Mesh.from_env) and stacked in one
    process: every loss, grad norm and param slice after 3 steps
    bit-equal, the same hops and reductions; each saved its laid-out state
    (on ranks rank 0 writes) and restored it bit-exactly; the launcher's
    losses on ``--data 2 --model 2`` (ranks under torchrun's env, or
    stacked) bit-equal too."""
    gloo, stacked, _, tmp = ranks
    assert set(gloo) == set(stacked)
    for k in gloo:
        assert np.array_equal(gloo[k], stacked[k]), k
    assert gloo["restored"].all() and stacked["restored"].all()
    a = np.load(tmp / "ck_gloo" / f"step_{MESH_TRAIN_STEPS:08d}" /
                "arrays.npz")
    b = np.load(tmp / "ck_stack" / f"step_{MESH_TRAIN_STEPS:08d}" /
                "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k


def test_ranks_match_the_single_device_step(ranks):
    """The rank job's losses and grad norms within rel 1e-5 of the
    single-device step's, and its counts equal step_counts."""
    gloo, _, shared, _ = ranks
    cfg = get_reduced("tinyllama-1.1b")
    pcfg = TS.ParallelConfig(fsdp=True)
    params = {}
    for k, v in shared.items():
        if k.startswith("param/"):
            node = params
            *head, last = k[6:].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = torch.from_numpy(v)
    state = TS.state_from_params(params, pcfg)
    single = TS.make_train_step(cfg, pcfg, P_opt.OptConfig(**RECIPE))
    mesh = make_local_mesh(2, 2, device="cpu")
    sh = TS.make_train_step(cfg, mesh, pcfg)[2](state)
    want = step_counts(state.params, sh.params, mesh, ("data",), pcfg, cfg)
    for i in range(MESH_TRAIN_STEPS):
        b = {k: torch.from_numpy(shared[f"{k}@{i}"])
             for k in ("tokens", "labels")}
        state, m = single(state, b)
        loss, gnorm = gloo["hist"][0, i]
        assert _rel(loss, m["loss"]) <= 1e-5 and _rel(
            gnorm, m["grad_norm"]) <= 1e-5, i
        assert tuple(gloo["counts"][0, i]) == (*want["data"],
                                               *want["model"])


# ------------------------------------------------ the launcher, example ---

def test_launcher_on_a_mesh_matches_one_device():
    """``--data 2 --model 2`` for 6 steps: the reference's JSON line, and
    losses within rel 1e-4 of ``--data 1 --model 1``'s."""
    from repro_torch.launch import train as P_launch
    argv = ["--device", "cpu", "--arch", "tinyllama-1.1b", "--reduced",
            "--steps", "6", "--batch", "4", "--seq", "32"]
    res1, _, h1 = P_launch.run(argv)
    res4, st, h4 = P_launch.run(argv + ["--data", "2", "--model", "2"])
    assert set(res4) == {"first_loss", "last_loss", "steps", "seconds"}
    assert res4["steps"] == 6
    for a, b in zip(h4["losses"], h1["losses"]):
        assert _rel(a, b) <= 1e-4
    assert st.step.shape == (4,) and int(st.step[0]) == 6


def test_elastic_example_runs_on_the_cpu(capsys):
    got = elastic_rescale.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "resumed at step 3 on (2, 2)" in out
    assert "elastic rescale OK: 4x2 -> 2x2 resume succeeded" in out
    assert got["resumed_step"] == 3
    assert all(math.isfinite(got[k]) for k in ("phase1_loss", "phase2_loss"))
