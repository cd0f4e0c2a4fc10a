"""The port's ``make_prefill_step`` and ``make_serve_step`` over a mesh
against the reference's jit-sharded steps on the same mesh, and against
the port's own single-device ``lm.prefill``/``decode_step``.

A prefill of 4 x 24 tokens into a cache of 40 slots, then 8 greedy decode
steps, on stacked CPU meshes: reduced tinyllama on 2 x 2, 1 x 4 (2 KV
heads whole on every device), 4 x 1 and with sequence parallelism on 1 x
2; gemma3 on 2 x 2 (its sliding-window layers' 16-slot rings rolled past
the window); gemma-7b (tied head) on 1 x 2; qwen2-vl (M-RoPE) on 2 x 2;
olmoe on 1 x 4 (experts over ``model``) and on 2 x 2 with ``moe_groups``
2.  The reference runs every case in one 4-device subprocess
(``_torch_tp.run_reference``).

Bars: the layout is the reference's: the port's ``shard`` of the
reference's final cache equals every device's addressable shard bit for
bit; the port's laid-out cache within 3e-5 of those shards; the prefill
and every decode step's logits within 3e-5 of the reference's and of the
single-device port's; greedy tokens equal.  The 2 x 2 serve job on 4 gloo
ranks equals the stacked one bit for bit.
"""
import numpy as np
import pytest
import torch

from _torch_ranks import run_gloo, run_stacked
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_tp import (batch_of, cfg_of, mesh_of, nest, port_params,
                       run_reference)
from repro_torch.checkpoint import manager as P_ckpt
from repro_torch.configs import get_reduced
from repro_torch.models import lm
from repro_torch.train import shardings as SH
from repro_torch.train import step as TS

B, S, L, STEPS = 4, 24, 40, 8
# (name, arch, data, model, pcfg)
CASES = [
    ("tiny_2x2", "tinyllama-1.1b", 2, 2, {}),
    ("tiny_1x4", "tinyllama-1.1b", 1, 4, {}),
    ("tiny_4x1", "tinyllama-1.1b", 4, 1, {}),
    ("tiny_sp_1x2", "tinyllama-1.1b", 1, 2, {"sequence_parallel": True}),
    ("gemma3_2x2", "gemma3-27b", 2, 2, {}),
    ("gemma7b_1x2", "gemma-7b", 1, 2, {}),
    ("qwen2vl_2x2", "qwen2-vl-72b", 2, 2, {}),
    ("olmoe_1x4", "olmoe-1b-7b", 1, 4, {}),
    ("olmoe_2x2_g2", "olmoe-1b-7b", 2, 2, {"moe_groups": 2}),
]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_steps")
    rng = np.random.default_rng(2)
    cases, inputs = [], {}
    for k, (name, arch, data, model, pcfg) in enumerate(CASES):
        cases.append({"name": name, "arch": arch, "data": data,
                      "model": model, "pcfg": pcfg, "dtype": "float32",
                      "seed": 20 + k, "batch": ["tokens"],
                      "kinds": ["serve"], "max_len": L, "steps": STEPS})
        inputs[f"{name}/tokens"] = rng.integers(
            0, get_reduced(arch).vocab_size, (B, S)).astype(np.int32)
    return cases, inputs, run_reference(cases, inputs, tmp)


def _close(got, want, what):
    err = float((got - torch.as_tensor(want)).abs().max())
    assert err <= 3e-5, (what, err)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_steps_match_the_reference_and_one_device(ref, name):
    cases, inputs, outs = ref
    case = next(c for c in cases if c["name"] == name)
    r = outs[name]
    cfg, mesh = cfg_of(case), mesh_of(case)
    pcfg = TS.ParallelConfig(**case["pcfg"])
    params = port_params(r)
    toks = batch_of(inputs, case)["tokens"]
    # the single-device port
    c1 = lm.init_cache(cfg, B, L, device="cpu")
    l1, _ = lm.prefill(cfg, params, toks, c1, moe_groups=pcfg.moe_groups)
    # the mesh: laid-out params and cache, the compiled steps
    cache = lm.init_cache(cfg, B, L, device="cpu")
    _, pcomp = TS.make_prefill_step(cfg, mesh, pcfg)
    _, scomp = TS.make_serve_step(cfg, mesh, pcfg)
    ps = SH.tree_shardings(params, mesh, SH.param_spec)
    cs = SH.tree_shardings(cache, mesh, SH.cache_spec)
    lg_sh = TS._logits_sharding(cfg, mesh, B)
    laid_p = SH.shard(params, ps)
    laid_c = SH.shard(cache, cs, stack_dim=1)
    batch = {"tokens": toks}
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
        d1, _ = lm.decode_step(cfg, params, c1, t1, S + i,
                               moe_groups=pcfg.moe_groups)
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
            _close(mine[k], shard, f"{path} on device {i},{j}")


def test_step_fn_takes_full_trees_and_writes_the_cache_in_place():
    """``step_fn`` of both steps: full params and cache, full logits, the
    given cache written in place, equal to the compiled step's."""
    cfg = get_reduced("tinyllama-1.1b")
    mesh = mesh_of({"data": 2, "model": 2})
    pcfg = TS.ParallelConfig()
    params = lm.init_lm(cfg, torch.Generator().manual_seed(3), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(3))
    c1 = lm.init_cache(cfg, B, L, device="cpu")
    l1, _ = lm.prefill(cfg, params, toks, c1)
    cache = lm.init_cache(cfg, B, L, device="cpu")
    pf, _ = TS.make_prefill_step(cfg, mesh, pcfg)
    sv, _ = TS.make_serve_step(cfg, mesh, pcfg)
    lg, back = pf(params, cache, {"tokens": toks})
    assert back is cache and tuple(lg.shape) == (B, S, cfg.vocab_size)
    _close(lg, l1, "prefill")
    tok = lg[:, -1:].argmax(-1).to(torch.int32)
    lg2, _ = sv(params, cache, tok, S)
    d1, _ = lm.decode_step(cfg, params, c1, tok, S)
    _close(lg2, d1, "decode")
    for (p, a), (_, b) in zip(P_ckpt._flatten(cache), P_ckpt._flatten(c1)):
        _close(a.float(), b.float(), p)


def test_serve_job_on_gloo_ranks_equals_the_stack(tmp_path):
    """The tp_serve job (reduced olmoe: attention heads, experts and vocab
    over ``model``; 2 x 2) on 4 gloo ranks and stacked: logits, greedy
    tokens, the laid-out cache and the counts bit-equal."""
    cfg = get_reduced("olmoe-1b-7b")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(9), device="cpu")
    shared = {f"param/{p}": l.numpy() for p, l in P_ckpt._flatten(params)}
    shared.update(arch=np.array("olmoe-1b-7b"), max_len=np.array(L),
                  steps=np.array(4),
                  tokens=np.random.default_rng(9).integers(
                      0, cfg.vocab_size, (B, S)).astype(np.int32))
    x = {"x": np.zeros((4, 1), np.float32)}
    gloo = run_gloo(["tp_serve"], 4, x, shared, tmp_path)["tp_serve"]
    stacked = run_stacked("tp_serve", 4, x, shared)
    assert set(gloo) == set(stacked)
    for k in gloo:
        assert np.array_equal(gloo[k], stacked[k]), k
