"""MLA, mamba, rwkv and the enc-dec model split over the ``model`` axis:
the port's ``make_prefill_step``/``make_serve_step`` over a laid-out
cache and its mesh ``make_train_step``, against the reference's
jit-sharded steps on the same mesh and against the port's own single
device.

Reduced deepseek-v2 (MLA's query heads, experts over ``model``) on 1 x 2
and 1 x 4, rwkv6 (heads and ``ff``) on 1 x 2, jamba (mamba's inner
channels, GQA, experts) on 2 x 2 and seamless-m4t (the encoder, self and
cross attention over heads) on 1 x 2.  Serving: a prefill of 4 x 24
tokens into a cache of 40 slots (seamless's over 8 encoder frames), then
8 greedy decode steps.  Training: one step of 8 x 32 tokens; with the
config's ``remat`` on, reduced tinyllama on 2 x 2 and jamba on 1 x 2
against the reference's checkpointed step.  The reference runs every case
in one 4-device subprocess (``_torch_tp.run_reference``).

Bars (f32): the port's ``shard`` of the reference's final cache equals
every device's addressable shard bit for bit, the port's laid-out cache
within 3e-5 of those shards; prefill and decode logits within 3e-5 of the
reference's and of the single-device port's; greedy tokens equal; the
step's loss and grad norm within rel 3e-5 of the reference's, its params
within 3e-5 where the single-device gradient is above 1e-6 and within lr
everywhere.
"""
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_tp import (RECIPE, batch_of, cfg_of, mesh_of, mesh_train, nest,
                       port_params, rel, run_reference)
from repro_torch.checkpoint import manager as P_ckpt
from repro_torch.configs import get_reduced
from repro_torch.models import lm
from repro_torch.train import shardings as SH
from repro_torch.train import step as TS

B, S, L, STEPS, T_ENC = 4, 24, 40, 8, 8
TB, TS_LEN = 8, 32
# (name, arch, data, model)
SERVE = [
    ("deepseek_1x2", "deepseek-v2-236b", 1, 2),
    ("deepseek_1x4", "deepseek-v2-236b", 1, 4),
    ("rwkv_1x2", "rwkv6-7b", 1, 2),
    ("jamba_2x2", "jamba-v0.1-52b", 2, 2),
    ("seamless_1x2", "seamless-m4t-medium", 1, 2),
]
# (name, arch, data, model, remat override or None)
TRAIN = [
    ("deepseek_tp_1x2", "deepseek-v2-236b", 1, 2, None),
    ("rwkv_tp_1x2", "rwkv6-7b", 1, 2, None),
    ("jamba_tp_2x2", "jamba-v0.1-52b", 2, 2, None),
    ("seamless_tp_1x2", "seamless-m4t-medium", 1, 2, None),
    ("tiny_remat_2x2", "tinyllama-1.1b", 2, 2, True),
    ("jamba_remat_1x2", "jamba-v0.1-52b", 1, 2, True),
]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("split_families")
    rng = np.random.default_rng(25)
    cases, inputs = [], {}
    for k, (name, arch, data, model) in enumerate(SERVE):
        cfg = get_reduced(arch)
        c = {"name": name, "arch": arch, "data": data, "model": model,
             "pcfg": {}, "dtype": "float32", "seed": 50 + k,
             "batch": ["tokens"], "kinds": ["serve"], "max_len": L,
             "steps": STEPS}
        inputs[f"{name}/tokens"] = rng.integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        if cfg.encdec:
            c["batch"].append("enc_embeds")
            inputs[f"{name}/enc_embeds"] = rng.standard_normal(
                (B, T_ENC, cfg.d_model)).astype(np.float32)
        cases.append(c)
    for k, (name, arch, data, model, remat) in enumerate(TRAIN):
        cfg = get_reduced(arch)
        c = {"name": name, "arch": arch, "data": data, "model": model,
             "pcfg": {}, "dtype": "float32", "seed": 70 + k,
             "batch": ["tokens", "labels"], "kinds": ["train"]}
        if remat is not None:
            c["remat"] = remat
        t = rng.integers(0, cfg.vocab_size, (TB, TS_LEN + 1)).astype(
            np.int32)
        inputs[f"{name}/tokens"] = t[:, :-1].copy()
        inputs[f"{name}/labels"] = t[:, 1:].copy()
        if cfg.encdec:
            c["batch"].append("enc_embeds")
            inputs[f"{name}/enc_embeds"] = rng.standard_normal(
                (TB, T_ENC, cfg.d_model)).astype(np.float32)
        cases.append(c)
    return cases, inputs, run_reference(cases, inputs, tmp)


def _close(got, want, what):
    err = float((got - torch.as_tensor(want)).abs().max())
    assert err <= 3e-5, (what, err)


def _get(ref, name):
    cases, inputs, outs = ref
    case = next(c for c in cases if c["name"] == name)
    return case, batch_of(inputs, case), outs[name]


@pytest.mark.parametrize("name", [c[0] for c in SERVE])
def test_serve_steps_match_the_reference_and_one_device(ref, name):
    """The prefill and decode steps over a laid-out cache: the reference's
    layout, its logits and greedy tokens, and the single device's."""
    case, batch, r = _get(ref, name)
    cfg, mesh = cfg_of(case), mesh_of(case)
    pcfg = TS.ParallelConfig()
    params = port_params(r)
    toks, enc = batch["tokens"], batch.get("enc_embeds")
    enc_len = 0 if enc is None else enc.shape[1]
    # the single-device port
    c1 = lm.init_cache(cfg, B, L, device="cpu", enc_len=enc_len)
    l1, _ = lm.prefill(cfg, params, toks, c1, enc_embeds=enc)
    # the mesh: laid-out params and cache, the compiled steps
    cache = lm.init_cache(cfg, B, L, device="cpu", enc_len=enc_len)
    _, pcomp = TS.make_prefill_step(cfg, mesh, pcfg)
    _, scomp = TS.make_serve_step(cfg, mesh, pcfg)
    ps = SH.tree_shardings(params, mesh, SH.param_spec)
    cs = SH.tree_shardings(cache, mesh, SH.cache_spec)
    lg_sh = TS._logits_sharding(cfg, mesh, B)
    laid_p = SH.shard(params, ps)
    laid_c = SH.shard(cache, cs, stack_dim=1)
    lg, laid_c = pcomp(params, cache, batch)(laid_p, laid_c, batch)
    full = SH.unshard({"l": lg}, {"l": lg_sh})["l"]
    _close(full, r["prefill_logits"], "prefill")
    _close(full, l1, "prefill against one device")
    tok = full[:, -1].argmax(-1)[:, None].to(torch.int32)
    t1 = l1[:, -1].argmax(-1)[:, None].to(torch.int32)
    sstep = scomp(params, cache, tok)
    got = [tok]
    for i in range(STEPS):
        lg, laid_c = sstep(laid_p, laid_c, tok, S + i)
        full = SH.unshard({"l": lg}, {"l": lg_sh})["l"]
        d1, _ = lm.decode_step(cfg, params, c1, t1, S + i)
        _close(full, r["decode_logits"][i], f"decode step {i}")
        _close(full, d1, f"decode step {i} against one device")
        tok = full[:, -1].argmax(-1)[:, None].to(torch.int32)
        t1 = d1[:, -1].argmax(-1)[:, None].to(torch.int32)
        got.append(tok)
        assert torch.equal(tok, t1), i
    assert np.array_equal(torch.cat(got, 1).numpy(), r["greedy"])
    ref_cache = SH.tree_map(torch.from_numpy, nest(r, "cache/"))
    laid_ref = SH.shard(ref_cache, cs)
    for (path, mine), (_, theirs) in zip(P_ckpt._flatten(laid_c),
                                         P_ckpt._flatten(laid_ref)):
        for k, (i, j) in enumerate(mesh.coords()):
            shard = r[f"shard/{path}@{i}_{j}"]
            assert np.array_equal(theirs[k].numpy(), shard), (path, i, j)
            _close(mine[k].float(), shard, f"{path} on device {i},{j}")


@pytest.mark.parametrize("name", [c[0] for c in TRAIN])
def test_train_step_matches_the_reference_sharded_step(ref, name):
    """One mesh train step against the reference's jit-sharded one (its
    ``remat`` as the case sets it): loss, grad norm and params."""
    case, batch, r = _get(ref, name)
    cfg = cfg_of(case)
    pcfg = TS.ParallelConfig()
    params = port_params(r)
    m, p1, _ = mesh_train(cfg, pcfg, mesh_of(case), params, batch)
    loss, _, _, _, gnorm = r["metrics"]
    assert rel(m["loss"], loss) <= 3e-5
    assert rel(m["grad_norm"], gnorm) <= 3e-5
    grads = TS.grads_of(cfg, pcfg, params, batch)[2]
    for (path, p), (_, g) in zip(P_ckpt._flatten(p1),
                                 P_ckpt._flatten(grads)):
        diff = (p - torch.from_numpy(r[f"p1/{path}"])).abs()
        assert (diff[g.abs() > 1e-6] <= 3e-5).all(), path
        assert (diff <= RECIPE["lr"]).all(), path

