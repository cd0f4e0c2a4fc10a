"""The port's tensor and sequence parallelism (the Megatron split of the
``model`` axis, ``models/sharding.py``) against the reference's
jit-sharded forward and train step on the same mesh.

Reduced tinyllama, gemma3 (sliding window), gemma-7b (tied head, GeGLU,
head dim 32) and qwen2-vl (M-RoPE over distinct temporal/height/width ids,
QKV bias) on stacked CPU meshes of 1 x 2, 2 x 2, 1 x 4 and 4 x 1, with
``tensor_parallel`` and with ``sequence_parallel``; reduced tinyllama at
``model`` 4 has 2 KV heads to 4 q heads, so every device keeps both KV
heads and hands K3 the one its q head uses.  The reference runs every case
in one 4-device subprocess (``_torch_tp.run_reference``).

Bars: f32 logits within 3e-5 of the reference's and the step's loss and
grad norm within rel 3e-5, step 1's params within 3e-5 where the
single-device gradient is above 1e-6 and within lr everywhere (Adam's
first step near eps moves anywhere within lr); bf16 logits within 2e-2
of their largest magnitude and the loss within rel 2e-2.  The 2 x 2 step
on 4 gloo ranks (``tests/_torch_ranks.py``) equals the stacked one bit
for bit.
"""
import numpy as np
import pytest
import torch

from _torch_ranks import run_gloo, run_stacked
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_tp import (RECIPE, batch_of, cfg_of, mesh_forward, mesh_of,
                       mesh_train, port_params, rel, run_reference)
from repro_torch.checkpoint import manager as P_ckpt
from repro_torch.configs import get_reduced
from repro_torch.models import lm
from repro_torch.train import step as TS

B, S = 8, 32
SP = {"sequence_parallel": True}
# (name, arch, data, model, pcfg, dtype)
CASES = [
    ("tiny_tp_1x2", "tinyllama-1.1b", 1, 2, {}, "float32"),
    ("tiny_tp_2x2", "tinyllama-1.1b", 2, 2, {}, "float32"),
    ("tiny_tp_1x4", "tinyllama-1.1b", 1, 4, {}, "float32"),
    ("tiny_tp_4x1", "tinyllama-1.1b", 4, 1, {}, "float32"),
    ("tiny_sp_2x2", "tinyllama-1.1b", 2, 2, SP, "float32"),
    ("tiny_sp_1x4", "tinyllama-1.1b", 1, 4, SP, "float32"),
    ("tiny_dp_2x2", "tinyllama-1.1b", 2, 2, {"tensor_parallel": False},
     "float32"),
    ("tiny_tp_2x2_bf16", "tinyllama-1.1b", 2, 2, {}, "bfloat16"),
    ("gemma3_tp_2x2", "gemma3-27b", 2, 2, {}, "float32"),
    ("gemma3_sp_1x2", "gemma3-27b", 1, 2, SP, "float32"),
    ("gemma7b_tp_2x2", "gemma-7b", 2, 2, {}, "float32"),
    ("gemma7b_sp_1x4", "gemma-7b", 1, 4, SP, "float32"),
    ("qwen2vl_tp_2x2", "qwen2-vl-72b", 2, 2, {}, "float32"),
    ("qwen2vl_sp_1x2", "qwen2-vl-72b", 1, 2, SP, "float32"),
]


def _case(name, arch, data, model, pcfg, dtype, seed):
    c = {"name": name, "arch": arch, "data": data, "model": model,
         "pcfg": pcfg, "dtype": dtype, "seed": seed,
         "batch": ["tokens", "labels"], "kinds": ["train"]}
    if pcfg.get("tensor_parallel", True):
        c["kinds"].append("forward")
    if get_reduced(arch).mrope:
        c["batch"].append("positions")
    return c


def _inputs(case, rng):
    cfg = get_reduced(case["arch"])
    t = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {f"{case['name']}/tokens": t[:, :-1].copy(),
           f"{case['name']}/labels": t[:, 1:].copy()}
    if cfg.mrope:
        # text, an 4 x 4 image at one temporal id, text: distinct ids
        pos = np.zeros((3, B, S), np.int32)
        for r in range(3):
            pos[r] = np.arange(S)
        grid = np.arange(16)
        pos[0, :, 8:24] = 8
        pos[1, :, 8:24] = 8 + grid // 4
        pos[2, :, 8:24] = 8 + grid % 4
        pos[:, :, 24:] = np.arange(24, S) - 8
        out[f"{case['name']}/positions"] = pos
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    rng = np.random.default_rng(0)
    cases = [_case(*c, seed=k) for k, c in enumerate(CASES)]
    inputs = {}
    for c in cases:
        inputs.update(_inputs(c, rng))
    return cases, inputs, run_reference(cases, inputs, tmp)


def _get(ref, name):
    cases, inputs, outs = ref
    case = next(c for c in cases if c["name"] == name)
    return case, batch_of(inputs, case), outs[name]


FORWARD = [c[0] for c in CASES if c[4].get("tensor_parallel", True)]


@pytest.mark.parametrize("name", FORWARD)
def test_forward_matches_the_reference_on_its_mesh(ref, name):
    case, batch, r = _get(ref, name)
    cfg = cfg_of(case)
    pcfg = TS.ParallelConfig(**case["pcfg"])
    logits, _ = mesh_forward(cfg, pcfg, mesh_of(case), port_params(r),
                             batch)
    want = torch.from_numpy(r["logits"])
    err = float((logits - want).abs().max())
    if case["dtype"] == "bfloat16":
        # bf16 logits of magnitude 2-8 are 1/64-1/16 apart: the bar is
        # relative to the largest
        assert err <= 2e-2 * float(want.abs().max()), err
    else:
        assert err <= 3e-5, err


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_train_step_matches_the_reference_sharded_step(ref, name):
    case, batch, r = _get(ref, name)
    cfg = cfg_of(case)
    pcfg = TS.ParallelConfig(**case["pcfg"])
    params = port_params(r)
    m, p1, _ = mesh_train(cfg, pcfg, mesh_of(case), params, batch)
    loss, _, _, _, gnorm = r["metrics"]
    if case["dtype"] == "bfloat16":
        assert rel(m["loss"], loss) <= 2e-2
        return
    assert rel(m["loss"], loss) <= 3e-5
    assert rel(m["grad_norm"], gnorm) <= 3e-5
    grads = TS.grads_of(cfg, pcfg, params, batch)[2]
    for (path, p), (_, g) in zip(P_ckpt._flatten(p1),
                                 P_ckpt._flatten(grads)):
        diff = (p - torch.from_numpy(r[f"p1/{path}"])).abs()
        assert (diff[g.abs() > 1e-6] <= 3e-5).all(), path
        assert (diff <= RECIPE["lr"]).all(), path


def test_the_model_axis_splits_the_compute():
    """On 1 x 4 each device computes one of reduced tinyllama's 4 q heads,
    a quarter of ``ff`` and of the vocab: the params the model sees are
    the compute slices, KV heads whole (2 do not divide 4), and the step's
    K3 input is the folded batch: one call a layer for the whole stack."""
    from repro_torch.kernels import ops
    from repro_torch.models import sharding as SHD
    from repro_torch.train import shardings as SH
    cfg = get_reduced("tinyllama-1.1b")
    mesh = mesh_of({"data": 1, "model": 4})
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    ps = SH.tree_shardings(params, mesh, SH.param_spec)
    with SHD.use_sharding(mesh, TS.sharding_rules(TS.ParallelConfig()),
                          batch_axes=()):
        full = TS.compute_params(cfg, mesh, SH.shard(params, ps), ps, ())
    mix, mlp = full["stage0"]["b0"]["mixer"], full["stage0"]["b0"]["mlp"]
    D = cfg.head_dim
    assert len(mix["wq"]) == cfg.n_layers        # one tensor a layer
    assert tuple(mix["wq"][0].shape) == (4, cfg.d_model, D)
    assert tuple(mix["wk"][0].shape) == (4, cfg.d_model, cfg.n_kv_heads * D)
    assert tuple(mlp["wo"][0].shape) == (4, cfg.d_ff // 4, cfg.d_model)
    assert tuple(full["embed"].shape) == (4, cfg.vocab_size // 4,
                                          cfg.d_model)
    calls = []
    real = ops.chunked_attention

    def spy(q, *a, **kw):
        calls.append(tuple(q.shape))
        return real(q, *a, **kw)
    ops.chunked_attention = spy
    try:
        b = {"tokens": torch.zeros((2, 16), dtype=torch.int32),
             "labels": torch.zeros((2, 16), dtype=torch.int32)}
        mesh_train(cfg, TS.ParallelConfig(), mesh, params, b)
    finally:
        ops.chunked_attention = real
    assert calls == [(4 * 2, 16, 1, D)] * cfg.n_layers


# ------------------------------------------------------------ the ranks ---

def test_tp_step_on_gloo_ranks_equals_the_stack(tmp_path):
    """The tp job (reduced tinyllama, 2 x 2, tensor and sequence
    parallel, 2 steps) on 4 gloo ranks (``Mesh.from_env``) and stacked:
    every loss, grad norm, param slice and hop/reduction count
    bit-equal."""
    cfg = get_reduced("tinyllama-1.1b")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(7), device="cpu")
    shared = {f"param/{p}": l.numpy() for p, l in P_ckpt._flatten(params)}
    rng = np.random.default_rng(7)
    t = rng.integers(0, cfg.vocab_size, (2, B, S + 1)).astype(np.int32)
    shared.update(tokens=t[..., :-1].copy(), labels=t[..., 1:].copy())
    x = {"x": np.zeros((4, 1), np.float32)}
    gloo = run_gloo(["tp_train"], 4, x, shared, tmp_path)["tp_train"]
    stacked = run_stacked("tp_train", 4, x, shared)
    assert set(gloo) == set(stacked)
    for k in gloo:
        assert np.array_equal(gloo[k], stacked[k]), k
