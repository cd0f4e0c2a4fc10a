"""The port's shardings (``train/shardings.py``), its mesh training step
and its elastic checkpoints against the reference's.

The rules and specs need no devices: the reference's ``param_spec`` reads
only ``mesh.axis_names`` and ``mesh.devices.shape``, so both packages take
the same stub mesh, at every config's full size.  The reference's sharded
state and step run once, in a subprocess with 8 forced host devices over
its ``make_local_mesh(4, 2)``: each device's ``addressable_shards``, three
sharded steps, a sharded checkpoint, and the restore of one the port wrote
on a 2 x 2 mesh.  The port runs the same numpy params and batches on a 4 x
2 stacked mesh on the CPU.  Bars: layouts and restores bit-exact; the
step's loss and grad norm within rel 1e-5 for 3 steps, step 1's params as
``test_torch_train._same_update``.
"""
import dataclasses
import json
import types

import jax
import numpy as np
import pytest
import torch

from _multidev import run_with_devices
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro.configs import ARCH_NAMES, get_config, get_reduced
from repro.launch import specs as R_specs
from repro.train import shardings as R_SH
from repro.train import step as R_step
from repro_torch.checkpoint import manager as P_ckpt
from repro_torch.configs import get_config as p_config
from repro_torch.configs import get_reduced as p_reduced
from repro_torch.launch import specs as P_specs
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.optim import adamw as P_opt
from repro_torch.train import shardings as SH
from repro_torch.train import step as P_step
from repro_torch.weights import params_from_jax

MESHES = {"4x4": ((4, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RECIPE = dict(lr=8e-3, warmup_steps=2, total_steps=40)
STEPS = 3
CFG = p_reduced("tinyllama-1.1b")


def _stub(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _jax_path(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name",
                                                  getattr(k, "idx", k))))
                    for k in path)


def _ref_specs(tree, fn, mesh, **kw):
    """{path: spec as a tuple} of the reference's ``fn`` over ``tree``."""
    return {_jax_path(p): tuple(fn(p, leaf, mesh, **kw))
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_specs(tree, fn, mesh, **kw):
    out = {}
    SH.tree_map(lambda p, leaf: out.__setitem__(
        SH._path_str(p), tuple(fn(p, leaf, mesh, **kw))), tree,
        with_path=True)
    return out


# --------------------------------------------------------------- rules ---

def test_rules_are_the_reference_rules():
    assert SH._PARAM_RULES == R_SH._PARAM_RULES
    assert SH._CACHE_RULES == R_SH._CACHE_RULES


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_cache_specs_equal_at_full_size(arch):
    """Every leaf's spec, at the config's full size, on the 4x4, 16x16
    and 2x16x16 meshes, with fsdp on and off; the caches at decode_32k."""
    rp = R_specs.param_specs(get_config(arch))
    pp = P_specs.param_specs(p_config(arch))
    rc = R_specs.cache_specs(get_config(arch), "decode_32k")
    pc = P_specs.cache_specs(p_config(arch), "decode_32k")
    for name in MESHES:
        mesh = _stub(name)
        for fsdp in (True, False):
            want = _ref_specs(rp, R_SH.param_spec, mesh, fsdp=fsdp)
            assert _port_specs(pp, SH.param_spec, mesh, fsdp=fsdp) == want
        assert (_port_specs(pc, SH.cache_spec, mesh)
                == _ref_specs(rc, R_SH.cache_spec, mesh))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_specs_equal(mesh_name, monkeypatch):
    """Batch specs over the default and all-axes DP axes, M-RoPE's (3, B,
    S) positions split on dim 1, a batch that does not divide left whole.
    (The reference's NamedSharding wants a real mesh: here it records the
    spec its batch_specs computes.)"""
    monkeypatch.setattr(R_SH, "NamedSharding", lambda mesh, spec:
                        types.SimpleNamespace(spec=spec))
    mesh = _stub(mesh_name)
    for arch in ("qwen2-vl-72b", "seamless-m4t-medium", "tinyllama-1.1b"):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            for b in (None, 3):
                rs = R_specs.input_specs(get_config(arch), shape)
                ps = P_specs.input_specs(p_config(arch), shape)
                if b is not None:
                    rs = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
                        (b,) + s.shape[1:] if s.ndim else s.shape, s.dtype),
                        rs)
                    ps = {k: v.new_empty(((b,) + tuple(v.shape[1:]))
                                         if v.ndim else ())
                          for k, v in ps.items()}
                for dp in (("pod", "data"), ("pod", "data", "model")):
                    want = {k: tuple(v.spec) for k, v in R_SH.batch_specs(
                        mesh, rs, dp_axes=dp).items()}
                    got = {k: tuple(v.spec) for k, v in SH.batch_specs(
                        mesh, ps, dp_axes=dp).items()}
                    assert got == want, (arch, shape, b, dp)


def test_sharding_rules_equal():
    for kw in ({}, {"sequence_parallel": True}, {"tensor_parallel": False},
               {"tensor_parallel": False, "sequence_parallel": True}):
        assert (P_step.sharding_rules(P_step.ParallelConfig(**kw))
                == R_step.sharding_rules(R_step.ParallelConfig(**kw)))


def test_fit_spec_drops_axes_that_do_not_divide():
    """test_sharding_rules.py's kv-head case: wk's output dim 17 stays
    whole over a model axis of 4, as the reference's."""
    cfg = dataclasses.replace(get_reduced("tinyllama-1.1b"), n_kv_heads=1,
                              head_dim=17)
    mesh = _stub("4x4")
    want = _ref_specs(R_specs.param_specs(cfg), R_SH.param_spec, mesh)
    got = _port_specs(P_specs.param_specs(dataclasses.replace(
        CFG, n_kv_heads=1, head_dim=17)), SH.param_spec, mesh)
    assert got == want
    assert got["stage0/b0/mixer/wk"][-1] is None


# ------------------------------------------------------ the reference run ---

REF = r"""
import json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import manager as ckpt
from repro.configs import get_reduced
from repro.data.pipeline import DataConfig, batch_at
from repro.launch.mesh import make_local_mesh
from repro.optim.adamw import OptConfig
from repro.train.step import (ParallelConfig, init_train_state, loss_fn,
                              make_train_step)

tmp, steps, recipe = {tmp!r}, {steps}, json.loads({recipe!r})
def name(path):
    return "/".join(str(getattr(k, "key", getattr(k, "name",
                                                  getattr(k, "idx", k))))
                    for k in path)
def flat(tree):
    return {{name(p): np.asarray(l)
             for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}}

cfg = get_reduced("tinyllama-1.1b")
mesh = make_local_mesh(4, 2)
pcfg = ParallelConfig(fsdp=True)
state = init_train_state(cfg, jax.random.key(0), pcfg)
_, compile_step, state_shardings = make_train_step(
    cfg, mesh, pcfg, OptConfig(**recipe), donate=False)
dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8,
                  repeat_len=8)
batches = [batch_at(dcfg, i) for i in range(steps)]
shapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                      (state, batches[0]))
step = compile_step(*shapes)
ss = state_shardings(shapes[0])
st = jax.device_put(state, ss)
np.savez(f"{{tmp}}/init.npz", **flat(state.params))
np.savez(f"{{tmp}}/batches.npz", **{{f"{{k}}@{{i}}": np.asarray(v)
                                     for i, b in enumerate(batches)
                                     for k, v in b.items()}})

# every device's shard of every leaf, by its mesh coordinate
coord = {{d.id: np.argwhere(mesh.devices == d)[0]
          for d in mesh.devices.flat}}
shards, specs = {{}}, {{}}
for p, leaf in jax.tree_util.tree_flatten_with_path(st)[0]:
    specs[name(p)] = [list(a) if isinstance(a, tuple) else a
                      for a in leaf.sharding.spec]
    for s in leaf.addressable_shards:
        i, j = coord[s.device.id]
        shards[f"{{name(p)}}@{{i}}_{{j}}"] = np.asarray(s.data)
np.savez(f"{{tmp}}/shards.npz", **shards)

grads = jax.jit(jax.grad(lambda p: loss_fn(cfg, pcfg, p, batches[0])[0]))(
    state.params)
np.savez(f"{{tmp}}/grads.npz", **flat(grads))
hist = []
for i, b in enumerate(batches):
    st, m = step(st, b)
    hist.append([float(m["loss"]), float(m["grad_norm"])])
    if i == 0:
        np.savez(f"{{tmp}}/params1.npz", **flat(st.params))
        np.savez(f"{{tmp}}/m1.npz", **flat(st.opt.m))
ckpt.save(st, f"{{tmp}}/ref_ckpt", steps)

# the port's checkpoint of a state laid out on its 2 x 2 mesh, restored
# onto this 4 x 2 one
saved = np.load(f"{{tmp}}/port_ckpt/step_{{steps:08d}}/arrays.npz")
back = ckpt.restore(state, f"{{tmp}}/port_ckpt", shardings=ss)
ok = all(np.array_equal(np.asarray(l), saved[name(p)])
         for p, l in jax.tree_util.tree_flatten_with_path(back)[0])
ok = ok and back.params["embed"].sharding.spec == P("model", "data")
json.dump({{"hist": hist, "specs": specs, "port_restored": bool(ok)}},
          open(f"{{tmp}}/ref.json", "w"))
print("REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's run; before it, the port saves a 2 x 2 laid-out
    state for it to restore."""
    tmp = tmp_path_factory.mktemp("shardings")
    pcfg = P_step.ParallelConfig(fsdp=True)
    state = P_step.init_train_state(
        CFG, torch.Generator().manual_seed(3), pcfg,
        device="cpu")
    state = state._replace(step=torch.tensor(STEPS, dtype=torch.int32))
    mesh = make_local_mesh(2, 2, device="cpu")
    _, _, state_shardings = P_step.make_train_step(CFG, mesh,
                                                   pcfg)
    sh = state_shardings(state)
    P_ckpt.save(SH.shard(state, sh), str(tmp / "port_ckpt"), STEPS,
                shardings=sh)
    out = run_with_devices(REF.format(tmp=str(tmp), steps=STEPS,
                                      recipe=json.dumps(RECIPE)), 8)
    assert "REF_OK" in out
    with open(tmp / "ref.json") as f:
        meta = json.load(f)
    load = lambda n: dict(np.load(tmp / f"{n}.npz"))     # noqa: E731
    return {"tmp": tmp, "meta": meta, "init": load("init"),
            "batches": load("batches"), "shards": load("shards"),
            "grads": load("grads"), "params1": load("params1"),
            "m1": load("m1"), "port_state": state}


def _nest(flat):
    """{"a/b": x} to nested dicts."""
    out = {}
    for k, v in flat.items():
        node = out
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _params(ref):
    return params_from_jax(_nest(ref["init"]), device="cpu")


def test_layouts_match_addressable_shards(ref):
    """Each device's slice of every leaf of the state on a 4 x 2 stacked
    mesh is the reference's shard for the device at the same coordinate,
    bit for bit, and the specs are the reference's."""
    pcfg = P_step.ParallelConfig(fsdp=True)
    state = P_step.state_from_params(_params(ref), pcfg)
    mesh = make_local_mesh(4, 2, device="cpu")
    _, _, state_shardings = P_step.make_train_step(CFG, mesh,
                                                   pcfg)
    sh = state_shardings(state)
    laid = SH.shard(state, sh)
    specs = ref["meta"]["specs"]
    shardings = dict(P_ckpt._flatten(sh))
    n = 0
    for path, leaf in P_ckpt._flatten(laid):
        want = [tuple(a) if isinstance(a, list) else a for a in specs[path]]
        assert _strip(shardings[path].spec) == _strip(want), path
        for k, (i, j) in enumerate(mesh.coords()):
            r = ref["shards"][f"{path}@{i}_{j}"]
            assert np.array_equal(leaf[k].numpy(), r), (path, i, j)
            n += 1
    assert n == 8 * len(specs)


def _strip(spec):
    """A spec without its trailing Nones."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def test_shard_unshard_round_trip(ref):
    state = P_step.state_from_params(_params(ref), P_step.ParallelConfig(fsdp=True))
    for shape in ((4, 2), (2, 2), (1, 2), (8, 1)):
        mesh = make_local_mesh(*shape, device="cpu")
        _, _, state_shardings = P_step.make_train_step(
            CFG, mesh, P_step.ParallelConfig(fsdp=True))
        sh = state_shardings(state)
        back = SH.unshard(SH.shard(state, sh), sh)
        for a, b in zip(P_ckpt._flatten(state), P_ckpt._flatten(back)):
            assert a[0] == b[0] and torch.equal(a[1], b[1]), (shape, a[0])


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_stacked_step_matches_the_reference_sharded_step(ref):
    """The 4 x 2 stacked step against the reference's 4 x 2 sharded step
    (fsdp, tensor_parallel): loss and grad norm within rel 1e-5 over 3
    steps; step 1's params and first moments by _same_update's rule."""
    cfg = CFG
    pcfg = P_step.ParallelConfig(fsdp=True)
    state = P_step.state_from_params(_params(ref), pcfg)
    mesh = make_local_mesh(4, 2, device="cpu")
    _, compile_step, state_shardings = P_step.make_train_step(
        cfg, mesh, pcfg, P_opt.OptConfig(**RECIPE))
    sh = state_shardings(state)
    batches = [{k: torch.from_numpy(ref["batches"][f"{k}@{i}"])
                for k in ("tokens", "labels")} for i in range(STEPS)]
    step = compile_step(state, batches[0])
    st = SH.shard(state, sh)
    for i, b in enumerate(batches):
        st, m = step(st, b)
        loss, gnorm = ref["meta"]["hist"][i]
        assert _rel(float(m["loss"]), loss) <= 1e-5, i
        assert _rel(float(m["grad_norm"]), gnorm) <= 1e-5, i
        if i == 0:
            full = SH.unshard(st, sh)
            for path, p in P_ckpt._flatten(full.params):
                diff = np.abs(p.numpy() - ref["params1"][path])
                g = np.abs(ref["grads"][path])
                assert (diff[g > 1e-6] <= 1e-5).all(), path
                assert (diff <= RECIPE["lr"]).all(), path
            for path, mm in P_ckpt._flatten(full.opt.m):
                r = ref["m1"][path]
                np.testing.assert_allclose(
                    mm.numpy(), r, rtol=0,
                    atol=max(1e-5 * float(np.abs(r).max()), 1e-9),
                    err_msg=path)


# --------------------------------------------------------- checkpoints ---

def test_reference_sharded_checkpoint_restores_onto_the_port_mesh(ref):
    """The reference's state, saved from its 4 x 2 mesh after 3 steps,
    restored onto the port's 2 x 2 and 8 x 1 stacked meshes: every local
    slice is the saved array's slice, bit for bit."""
    tmp = ref["tmp"]
    saved = np.load(tmp / "ref_ckpt" / f"step_{STEPS:08d}" / "arrays.npz")
    pcfg = P_step.ParallelConfig(fsdp=True)
    like = P_step.state_from_params(_params(ref), pcfg)
    for shape in ((2, 2), (8, 1)):
        mesh = make_local_mesh(*shape, device="cpu")
        _, _, state_shardings = P_step.make_train_step(CFG, mesh,
                                                       pcfg)
        sh = state_shardings(like)
        back = P_ckpt.restore(like, str(tmp / "ref_ckpt"), shardings=sh)
        assert int(back.step[0]) == STEPS
        paths = dict(P_ckpt._flatten(sh))
        for path, leaf in P_ckpt._flatten(back):
            a = saved[path]
            for k, s in enumerate(paths[path].slices(a.shape)):
                assert np.array_equal(leaf[k].numpy(), a[s]), (shape, path)


def test_port_sharded_checkpoint_restores_in_the_reference(ref):
    """The port's state, laid out on its 2 x 2 mesh and saved there,
    holds its full arrays in the reference's format, and the reference
    restores it onto its 4 x 2 mesh with its shardings."""
    assert ref["meta"]["port_restored"]
    saved = np.load(ref["tmp"] / "port_ckpt" / f"step_{STEPS:08d}"
                    / "arrays.npz")
    for path, leaf in P_ckpt._flatten(ref["port_state"]):
        assert np.array_equal(saved[path], leaf.numpy()), path


def test_elastic_restore_different_mesh(tmp_path):
    """test_checkpoint.py's ELASTIC case on the port: saved whole,
    restored onto a 2 x 4 stacked mesh as P("data", "model") and
    P("model")."""
    tree = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.ones(8)}
    P_ckpt.save(tree, str(tmp_path), 1)
    mesh = make_local_mesh(2, 4, device="cpu")
    sh = {"w": SH.NamedSharding(mesh, SH.P("data", "model")),
          "b": SH.NamedSharding(mesh, SH.P("model"))}
    back = P_ckpt.restore(tree, str(tmp_path), shardings=sh)
    assert tuple(back["w"].shape) == (8, 4, 2)
    assert tuple(back["b"].shape) == (8, 2)
    full = SH.unshard(back, sh)
    assert torch.equal(full["w"], torch.arange(64.0).reshape(8, 8))
    assert torch.equal(full["b"], torch.ones(8))
    assert sh["w"].spec == SH.P("data", "model")
    with pytest.raises(ValueError, match="not both"):
        P_ckpt.restore(tree, str(tmp_path), device="cpu", shardings=sh)


# ---------------------------------------------------------------- specs ---

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_launch_specs_equal(arch):
    """input_specs, param_specs, state_specs and cache_specs: the
    reference's shapes and dtypes for every config at full size, the
    port's on the meta device."""
    def ref_tree(t):
        return {_jax_path(p): (tuple(l.shape), str(l.dtype))
                for p, l in jax.tree_util.tree_flatten_with_path(t)[0]}

    def port_tree(t):
        out = {}
        SH.tree_map(lambda p, l: out.__setitem__(SH._path_str(p), (
            tuple(l.shape), str(l.dtype).replace("torch.", ""))), t,
            with_path=True)
        assert all(l.device.type == "meta" for _, l in P_ckpt._flatten(t))
        return out

    rc, pc = get_config(arch), p_config(arch)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert (port_tree(P_specs.input_specs(pc, shape))
                == ref_tree(R_specs.input_specs(rc, shape)))
    assert port_tree(P_specs.param_specs(pc)) == ref_tree(
        R_specs.param_specs(rc))
    for gc in (False, True):
        assert port_tree(P_specs.state_specs(
            pc, P_step.ParallelConfig(grad_compress=gc))) == ref_tree(
                R_specs.state_specs(rc, R_step.ParallelConfig(
                    grad_compress=gc)))
    assert port_tree(P_specs.cache_specs(pc, "decode_32k")) == ref_tree(
        R_specs.cache_specs(rc, "decode_32k"))
    assert P_specs.ENC_LEN_DECODE == R_specs.ENC_LEN_DECODE
