"""``cfg.remat``: each rep of a stage's layer group (and each encoder
layer) runs under activation checkpointing, as the reference's scan body
under ``jax.checkpoint``, and in the mesh steps each rep's params are
gathered inside it (ZeRO-3).

Bars: a step with remat equals the step without it bit for bit, on one
device and on a stacked mesh (the recompute replays the same ops on the
same inputs); with remat no rep's gathered params outlive its forward,
and the bytes the forward saves for the backward (outside the
checkpointed reps) fall by at least every rep's gathered params; the
recompute of an MoE rep dispatches its tokens exactly as its forward did.
"""
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_tp import RECIPE
from repro_torch.checkpoint import manager as P_ckpt
from repro_torch.configs import get_reduced
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import lm
from repro_torch.models import moe as MOE
from repro_torch.models import sharding as SHD
from repro_torch.optim import adamw
from repro_torch.train import shardings as SH
from repro_torch.train import step as TS

B, S, T_ENC = 8, 32, 8


def _cfg(arch, remat):
    return dataclasses.replace(get_reduced(arch), remat=remat)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    b = {"tokens": torch.from_numpy(t[:, :-1].copy()),
         "labels": torch.from_numpy(t[:, 1:].copy())}
    if cfg.encdec:
        b["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, T_ENC, cfg.d_model)).astype(np.float32))
    return b


def _params(cfg, seed=0):
    return lm.init_lm(cfg, torch.Generator().manual_seed(seed),
                      device="cpu")


def _step(cfg, params, batch, mesh=None):
    """One train step from step 0: (metrics, params after it)."""
    ocfg = adamw.OptConfig(**RECIPE)
    if mesh is None:
        pcfg = TS.ParallelConfig(fsdp=False)
        st, m = TS.make_train_step(cfg, pcfg, ocfg, donate=False)(
            TS.state_from_params(params, pcfg), batch)
        return m, st.params
    pcfg = TS.ParallelConfig()
    step_fn, _, _ = TS.make_train_step(cfg, mesh, pcfg, ocfg)
    st, m = step_fn(TS.state_from_params(params, pcfg), batch)
    return m, st.params


@pytest.mark.parametrize("arch,mesh", [
    ("tinyllama-1.1b", None), ("jamba-v0.1-52b", None),
    ("seamless-m4t-medium", None), ("tinyllama-1.1b", (2, 2)),
    ("jamba-v0.1-52b", (1, 2)), ("deepseek-v2-236b", (1, 2)),
    ("rwkv6-7b", (1, 2)), ("seamless-m4t-medium", (1, 2))])
def test_remat_step_equals_the_step_without_it(arch, mesh):
    params = _params(get_reduced(arch))
    batch = _batch(get_reduced(arch))
    m_of = None if mesh is None else make_local_mesh(*mesh, device="cpu")
    m0, p0 = _step(_cfg(arch, False), params, batch, m_of)
    m1, p1 = _step(_cfg(arch, True), params, batch, m_of)
    for k in ("loss", "grad_norm", "aux"):
        assert torch.equal(m0[k], m1[k]), k
    for (path, a), (_, b) in zip(P_ckpt._flatten(p0), P_ckpt._flatten(p1)):
        assert torch.equal(a, b), path


def _forward_saves(cfg, mesh, params, batch):
    """The mesh step's forward (``loss_fn`` over ``compute_params``,
    grad on): (bytes of the distinct storages it saves for the backward
    outside any checkpointed rep, the gathered bytes of every rep's
    params, how many of the reps' gathered params are still alive once
    the forward is done)."""
    pcfg = TS.ParallelConfig()
    ps = SH.tree_shardings(params, mesh, SH.param_spec)
    leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(),
                            SH.shard(params, ps))
    bs = SH.batch_specs(mesh, batch)
    axes = TS._batch_axes(mesh, bs)
    folded = SH.tree_map(TS._fold, SH.shard(batch, bs), bs)
    saved, fetched = {}, []
    real = TS.Reps.__getitem__

    def spy(self, r):
        x = real(self, r)
        fetched.append((weakref.ref(x), x.numel() * x.element_size()))
        return x

    def pack(t):
        st = t.untyped_storage()
        saved[st.data_ptr()] = st.nbytes()
        return t

    TS.Reps.__getitem__ = spy
    try:
        with torch.enable_grad(), SHD.use_sharding(
                mesh, TS.sharding_rules(pcfg), batch_axes=axes), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            full = TS.compute_params(cfg, mesh, leaves, ps, axes)
            loss, _ = TS.loss_fn(cfg, pcfg, full, folded)
    finally:
        TS.Reps.__getitem__ = real
    gc.collect()
    alive = sum(ref() is not None for ref, _ in fetched)
    gathered = sum(n for _, n in fetched)
    loss.sum().backward()
    return sum(saved.values()), gathered, alive, len(fetched)


@pytest.mark.parametrize("arch,shape", [("tinyllama-1.1b", (2, 2)),
                                        ("jamba-v0.1-52b", (1, 2))])
def test_remat_holds_no_gathered_layer_copy(arch, shape):
    """ZeRO-3: with remat no rep's gathered params are alive after the
    forward (without it the backward keeps them), and the forward saves
    at least every rep's gathered params fewer bytes."""
    mesh = make_local_mesh(*shape, device="cpu")
    params = _params(get_reduced(arch))
    batch = _batch(get_reduced(arch))
    plain, gathered, alive0, n0 = _forward_saves(
        _cfg(arch, False), mesh, params, batch)
    remat, gathered1, alive1, n1 = _forward_saves(
        _cfg(arch, True), mesh, params, batch)
    reps = sum(reps for reps, _ in lm.stages_of(get_reduced(arch)))
    assert gathered1 == gathered and n1 == n0 and n0 >= reps
    assert alive1 == 0 and alive0 > 0, (alive0, alive1)
    assert remat <= plain - gathered, (plain, remat, gathered)


def test_moe_recompute_dispatches_as_its_forward():
    """Reduced jamba on 2 x 2 with remat: each MoE layer's dispatch (its
    capacity cuts) in the backward's recompute equals its forward's."""
    cfg = _cfg("jamba-v0.1-52b", True)
    mesh = make_local_mesh(2, 2, device="cpu")
    calls = {False: [], True: []}          # in the backward or not
    real = MOE._dispatch

    def spy(ids, *a, **kw):
        out = real(ids, *a, **kw)
        backward = torch._C._current_graph_task_id() != -1
        calls[backward].append((ids.clone(), tuple(t.clone() for t in out)))
        return out
    MOE._dispatch = spy
    try:
        _step(cfg, _params(cfg), _batch(cfg), mesh)
    finally:
        MOE._dispatch = real
    fwd, again = calls[False], calls[True]
    n = sum(k == "moe" for k in cfg.mlp_kinds())
    assert n > 0 and len(fwd) == len(again) == n
    # the backward recomputes the last rep first: pair each recompute
    # with the forward call of its layer (the same routed expert ids)
    for ids, out in again:
        same = [o for i, o in fwd if torch.equal(i, ids)]
        assert len(same) == 1
        assert all(torch.equal(a, b) for a, b in zip(same[0], out))
