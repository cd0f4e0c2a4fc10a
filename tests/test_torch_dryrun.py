"""The port's dry run (``repro_torch.launch.dryrun``) and production mesh.

* Every leaf's local shape, for every arch, on the layout-only 16 x 16 and
  2 x 16 x 16 meshes, equals the reference's
  ``NamedSharding(AbstractMesh(...), spec).shard_shape(...)`` for the
  params (as the training state lays them out) and the decode cache.
* One full-config cell per mesh kind runs end to end on the CPU, and the
  reference's report renderer (a pinned copy) reads its artifact.
* On a 2 x 2 stacked mesh on the CPU, one real step of reduced tinyllama
  (a training step, a serving prefill and decode step) moves exactly the
  collective bytes the dry run's formulas predict, as the axes' byte
  counters record them (hops and reductions).
* The flop count carried by a quadratic fit (recurrent models) equals a
  direct count.
"""
import dataclasses
import json
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as RNamedSharding

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs import ARCH_NAMES, get_config
from repro.launch import specs as R_specs
from repro.train import shardings as R_SH
from repro_torch.configs import get_config as p_config
from repro_torch.configs import get_reduced as p_reduced
from repro_torch.configs.base import ShapeConfig, param_count
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as P_specs
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.optim import adamw as P_opt
from repro_torch.roofline import cost as C
from repro_torch.roofline import report as RPT
from repro_torch.train import shardings as SH
from repro_torch.train import step as TS

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_path(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name",
                                                  getattr(k, "idx", k))))
                    for k in path)


def _ref_local(tree, spec_fn, kind, **kw):
    """{path: local shape} of the reference's layout of ``tree`` on the
    abstract production mesh: its spec functions read only the mesh's axis
    names and device shape, the shard shapes come from jax itself."""
    shape, names = MESHES[kind]
    stub = types.SimpleNamespace(axis_names=names, devices=np.empty(shape))
    mesh = AbstractMesh(shape, names)
    return {_jax_path(p): tuple(RNamedSharding(
        mesh, spec_fn(p, leaf, stub, **kw)).shard_shape(leaf.shape))
        for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_local(tree, shardings):
    out = {}
    SH.tree_map(lambda p, x, sh: out.__setitem__(
        SH._path_str(p), tuple(sh.local_shape(x.shape))), tree, shardings,
        with_path=True)
    return out


@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_local_shapes_equal_the_reference(arch, kind):
    mesh = make_production_mesh(multi_pod=kind == "multi")
    cfg = p_config(arch)
    pcfg = TS.ParallelConfig()
    state = P_specs.state_specs(cfg, pcfg, param_dtype=torch.bfloat16)
    _, _, state_shardings = TS.make_train_step(cfg, mesh, pcfg)
    ss = state_shardings(state)
    rp = R_specs.param_specs(get_config(arch))
    want = _ref_local(rp, R_SH.param_spec, kind, fsdp=True)
    assert _port_local(state.params, ss.params) == want
    assert _port_local(state.opt.m, ss.opt.m) == want
    rc = R_specs.cache_specs(get_config(arch), "decode_32k")
    pc = P_specs.cache_specs(cfg, "decode_32k")
    assert _port_local(pc, SH.tree_shardings(pc, mesh, SH.cache_spec)) == \
        _ref_local(rc, R_SH.cache_spec, kind)


def test_production_mesh_is_a_layout_without_devices():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.devices.shape == (2, 16, 16) and multi.n_local == 0
    ax = multi.axis("model")
    assert (ax.name, ax.size) == ("model", 16)
    for op in (lambda: ax.ppermute(torch.zeros(1), [(0, 1)]),
               lambda: ax.psum(torch.zeros(1)), lambda: ax.index(),
               lambda: multi.counts(), lambda: multi.reset_counts()):
        with pytest.raises(RuntimeError, match="layout-only"):
            op()


def _args(arch, shape, mesh):
    return DR._parser().parse_args(["--arch", arch, "--shape", shape,
                                    "--mesh", mesh])


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_full_config_cell_end_to_end(mesh, tmp_path):
    art = DR.run_cell(_args("tinyllama-1.1b", "decode_32k", mesh))
    assert art["status"] == "ok"
    assert art["n_chips"] == (256 if mesh == "single" else 512)
    m = art["memory"]
    cfg = p_config("tinyllama-1.1b")
    pc = P_specs.cache_specs(cfg, "decode_32k")
    lay = make_production_mesh(multi_pod=mesh == "multi")
    assert m["cache_bytes"] == DR._local_bytes(
        pc, SH.tree_shardings(pc, lay, SH.cache_spec))
    assert m["argument_size_bytes"] == (m["params_bytes"] + m["cache_bytes"]
                                        + m["batch_bytes"])
    assert m["fits_80gb"] is True
    r = art["roofline"]
    assert r["model_flops"] == 2.0 * 128 * param_count(cfg,
                                                       active_only=True)
    assert art["hlo_cost"]["flops"] * art["n_chips"] == \
        art["hlo_cost"]["flops_global"]
    assert set(art["collectives"]) == set(DR.COLLECTIVE_KINDS)
    json.dumps(art, allow_nan=False)
    # the reference's renderer reads the artifact
    (tmp_path / f"tinyllama-1.1b_decode_32k_{mesh}_baseline.json").write_text(
        json.dumps(art, allow_nan=False))
    cells = RPT.load(str(tmp_path))
    assert len(cells) == 1
    assert "tinyllama-1.1b" in RPT.fmt_table(cells, mesh)
    assert "decode_32k" in RPT.fmt_dryrun_summary(cells)


def test_skipped_cell():
    art = DR.run_cell(_args("tinyllama-1.1b", "long_500k", "single"))
    assert art["status"] == "skipped"


CASES = [  # (tensor_parallel, fsdp, remat, sequence_parallel, compress)
    (False, True, False, False, False),
    (False, True, True, False, False),
    (True, True, False, False, False),
    (True, True, True, True, False),
    (True, False, False, True, True),
]


@pytest.mark.parametrize("tp,fsdp,remat,sp,gc", CASES)
def test_predicted_collective_bytes_equal_the_counters(tp, fsdp, remat, sp,
                                                       gc):
    cfg = dataclasses.replace(p_reduced("tinyllama-1.1b"), remat=remat)
    pcfg = TS.ParallelConfig(fsdp=fsdp, tensor_parallel=tp,
                             sequence_parallel=sp, grad_compress=gc)
    state = TS.state_from_params(lm.init_lm(
        cfg, torch.Generator().manual_seed(0), device="cpu"), pcfg)
    B, S = 8, 32
    t = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(t[:, :-1].copy()),
             "labels": torch.from_numpy(t[:, 1:].copy())}
    mesh = make_local_mesh(2, 2, device="cpu")
    _, compile_step, state_shardings = TS.make_train_step(
        cfg, mesh, pcfg, P_opt.OptConfig())
    sh = state_shardings(state)
    step = compile_step(state, batch)
    laid = SH.shard(state, sh)
    mesh.reset_counts()
    step(laid, batch)
    dp = ("data",) if tp else ("data", "model")
    batch_axes = tuple(a for a in dp if mesh.shape[a] > 1)
    kinds = {}
    hops = C.mesh_step_link_bytes(state.params, sh.params, mesh, batch_axes,
                                  pcfg, cfg, kinds=kinds)
    reds = C.mesh_step_reduction_bytes(state.params, sh.params, mesh,
                                       batch_axes, pcfg, cfg, B, S)
    got = mesh.byte_counts()
    assert hops == {a: h for a, (h, _) in got.items()}
    assert reds == {a: r for a, (_, r) in got.items()}
    assert sum(k["count"] for k in kinds.values()) == sum(
        h for h, _ in mesh.counts().values())
    assert sum(k["link_bytes"] for k in kinds.values()) == sum(hops.values())


def test_fit_carries_a_recurrent_count_exactly():
    cfg = p_reduced("rwkv6-7b")
    shape = ShapeConfig(name="x", kind="prefill", seq_len=384,
                        global_batch=2)
    pcfg = TS.ParallelConfig()
    fit = DR.cell_flops(cfg, shape, pcfg)
    assert fit["counted_at"] == list(DR.FIT_LENGTHS)
    assert fit["flops"] == DR._count(cfg, shape, pcfg, 384)["flops"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_predicted_serving_bytes_equal_the_counters(kind):
    """A serving step (tensor parallel, the dry run's default) on a 2 x 2
    stacked mesh: its param gathers a rep at a time over ``data`` and its
    forward's model-axis all-reduces, as the counters record them."""
    cfg = p_reduced("tinyllama-1.1b")
    pcfg = TS.ParallelConfig()
    B, S, L = 4, 16, 32
    params = lm.init_lm(cfg, torch.Generator().manual_seed(3), device="cpu")
    mesh = make_local_mesh(2, 2, device="cpu")
    cache = lm.init_cache(cfg, B, L, device="cpu")
    ps = SH.tree_shardings(params, mesh, SH.param_spec)
    cs = SH.tree_shardings(cache, mesh, SH.cache_spec)
    laid_p = SH.shard(params, ps)
    laid_c = SH.shard(cache, cs, stack_dim=1)
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int32)}
    tok = torch.zeros((B, 1), dtype=torch.int32)
    if kind == "prefill":
        step = TS.make_prefill_step(cfg, mesh, pcfg)[1](params, cache, batch)
        run = lambda: step(laid_p, laid_c, batch)          # noqa: E731
    else:
        step = TS.make_serve_step(cfg, mesh, pcfg)[1](params, cache, tok)
        run = lambda: step(laid_p, laid_c, tok, S)         # noqa: E731
    batch_axes = TS._batch_axes(mesh, SH.batch_specs(mesh, batch))
    mesh.reset_counts()
    run()
    got = mesh.byte_counts()
    assert C.mesh_step_link_bytes(params, ps, mesh, batch_axes, pcfg, cfg,
                                  backward=False) == {
        a: h for a, (h, _) in got.items()}
    assert C.mesh_step_reduction_bytes(
        params, ps, mesh, batch_axes, pcfg, cfg, B,
        S if kind == "prefill" else 1, backward=False) == {
        a: r for a, (_, r) in got.items()}
