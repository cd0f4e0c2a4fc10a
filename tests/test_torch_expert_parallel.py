"""The port's expert parallelism (``models/moe.py::_moe_split``) against
the reference's jit-sharded forward and train step on the same mesh.

Reduced olmoe-1b-7b (8 experts, top 2) at 8 x 32 tokens (T = 256) on
stacked CPU meshes: experts over ``model`` (each device computes its own
experts' share of its model group's tokens; the combine reduces over the
model axis), the routing groups the reference's over the GLOBAL batch,
``moe_groups`` 0 (one group of 256 spanning every data device), 2 (groups
of 128: one a device on 2 x 2, spanning two devices on 4 x 1) and 4
(groups of 64: two a device on 2 x 2, one a device on 4 x 1), with
sequence parallelism, with ``tensor_parallel=False`` (experts whole, the
batch over every axis), and reduced deepseek-v2 (MLA whole on every
device, a shared expert split over ``ff``).  The reference runs every case
in one 4-device subprocess (``_torch_tp.run_reference``).

Bars: logits within 3e-5 and the aux loss within rel 1e-5 of the
reference's; the step's loss, aux loss and grad norm within rel 3e-5,
step 1's params within 3e-5 where the single-device gradient is above 1e-6
and within lr everywhere.
"""
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_tp import (RECIPE, batch_of, cfg_of, mesh_forward, mesh_of,
                       mesh_train, port_params, rel, run_reference)
from repro_torch.checkpoint import manager as P_ckpt
from repro_torch.configs import get_reduced
from repro_torch.models import lm
from repro_torch.models import moe as MOE
from repro_torch.models import sharding as SHD
from repro_torch.train import step as TS

B, S = 8, 32
OLMOE = "olmoe-1b-7b"
# (name, arch, data, model, pcfg)
CASES = [
    ("ep_1x2", OLMOE, 1, 2, {}),
    ("ep_2x2", OLMOE, 2, 2, {}),
    ("ep_4x1", OLMOE, 4, 1, {}),
    ("ep_1x4", OLMOE, 1, 4, {}),
    ("ep_2x2_g2", OLMOE, 2, 2, {"moe_groups": 2}),
    ("ep_4x1_g2", OLMOE, 4, 1, {"moe_groups": 2}),
    ("ep_2x2_g4", OLMOE, 2, 2, {"moe_groups": 4}),
    ("ep_4x1_g4", OLMOE, 4, 1, {"moe_groups": 4}),
    ("ep_sp_2x2", OLMOE, 2, 2, {"sequence_parallel": True}),
    ("ep_dp_2x2", OLMOE, 2, 2, {"tensor_parallel": False}),
    ("deepseek_2x2", "deepseek-v2-236b", 2, 2, {}),
]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("expert_parallel")
    rng = np.random.default_rng(1)
    cases, inputs = [], {}
    for k, (name, arch, data, model, pcfg) in enumerate(CASES):
        kinds = ["train"]
        if pcfg.get("tensor_parallel", True):
            kinds.append("forward")
        cases.append({"name": name, "arch": arch, "data": data,
                      "model": model, "pcfg": pcfg, "dtype": "float32",
                      "seed": 10 + k, "batch": ["tokens", "labels"],
                      "kinds": kinds})
        t = rng.integers(0, get_reduced(arch).vocab_size,
                         (B, S + 1)).astype(np.int32)
        inputs[f"{name}/tokens"] = t[:, :-1].copy()
        inputs[f"{name}/labels"] = t[:, 1:].copy()
    return cases, inputs, run_reference(cases, inputs, tmp)


def _get(ref, name):
    cases, inputs, outs = ref
    case = next(c for c in cases if c["name"] == name)
    return case, batch_of(inputs, case), outs[name]


@pytest.mark.parametrize("name", [c[0] for c in CASES
                                  if c[4].get("tensor_parallel", True)])
def test_forward_and_aux_match_the_reference(ref, name):
    case, batch, r = _get(ref, name)
    pcfg = TS.ParallelConfig(**case["pcfg"])
    logits, aux = mesh_forward(cfg_of(case), pcfg, mesh_of(case),
                               port_params(r), batch)
    err = float((logits - torch.from_numpy(r["logits"])).abs().max())
    assert err <= 3e-5, err
    assert rel(aux, r["aux"]) <= 1e-5
    assert float(aux) > 0


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_train_step_matches_the_reference_sharded_step(ref, name):
    case, batch, r = _get(ref, name)
    cfg = cfg_of(case)
    pcfg = TS.ParallelConfig(**case["pcfg"])
    params = port_params(r)
    m, p1, _ = mesh_train(cfg, pcfg, mesh_of(case), params, batch)
    loss, _, aux, _, gnorm = r["metrics"]
    assert rel(m["loss"], loss) <= 3e-5
    assert rel(m["aux"], aux) <= 3e-5
    assert rel(m["grad_norm"], gnorm) <= 3e-5
    grads = TS.grads_of(cfg, pcfg, params, batch)[2]
    for (path, p), (_, g) in zip(P_ckpt._flatten(p1),
                                 P_ckpt._flatten(grads)):
        diff = (p - torch.from_numpy(r[f"p1/{path}"])).abs()
        assert (diff[g.abs() > 1e-6] <= 3e-5).all(), path
        assert (diff <= RECIPE["lr"]).all(), path


@pytest.mark.parametrize("groups,shape", [(0, (4, 1)), (2, (4, 1)),
                                          (4, (2, 2)), (3, (2, 1))])
def test_split_routing_drops_what_one_device_drops(groups, shape):
    """At capacity factor 0.5 experts overflow: the split block's output
    over a mesh whose groups span, split or align with the devices' rows
    equals the single device's ``moe_block`` over the whole batch within
    1e-5 (the same entries drop), its aux loss too.  (T = 8 x 12 = 96:
    3 groups of 32 on 2 data devices of 48 tokens cut a group in two.)"""
    from repro_torch.launch.mesh import make_local_mesh
    cfg = get_reduced(OLMOE)
    params = lm.init_lm(cfg, torch.Generator().manual_seed(4),
                        device="cpu")["stage0"]["b0"]["mlp"]
    p = {k: v[0] for k, v in params.items()}
    x = torch.randn((8, 12, cfg.d_model), generator=torch.Generator()
                    .manual_seed(5))
    want, aux = MOE.moe_block(p, x, top_k=cfg.top_k, capacity_factor=0.5,
                              n_groups=groups)
    mesh = make_local_mesh(*shape, device="cpu")
    n, d = mesh.n_local, shape[0]
    # each device's rows (its data slice) and experts (its model slice)
    rows = x.reshape(d, 8 // d, 12, -1)[mesh.coords()[:, 0]]
    e = cfg.n_experts // shape[1]
    lp = {"router": p["router"].expand(n, -1, -1)}
    for k in ("wi_gate", "wi_up", "wo"):
        lp[k] = torch.stack([p[k][j * e:(j + 1) * e]
                             for j in mesh.coords()[:, 1]])
    with SHD.use_sharding(mesh, batch_axes=("data",)):
        got, got_aux = MOE.moe_block(
            lp, rows.flatten(0, 1), top_k=cfg.top_k, capacity_factor=0.5,
            n_groups=groups)
    got = got.reshape(n, 8 // d, 12, -1)
    for i, (a, _) in enumerate(mesh.coords()):
        torch.testing.assert_close(got[i], want.reshape(d, 8 // d, 12, -1)
                                   [a], rtol=0, atol=1e-5)
    assert rel(got_aux[0], aux) <= 1e-5
