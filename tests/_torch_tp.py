"""Shared by the port's split-compute tests (tensor, sequence and expert
parallelism; the prefill and decode steps over a mesh).

The reference runs every case of a test file in ONE subprocess with 4
forced host devices (:func:`run_reference`): for each case it draws its
params (``init_lm`` at the case's seed), and on the case's mesh runs what
the case asks: ``forward`` (``lm.forward`` jitted under ``use_sharding``),
``train`` (one step of its jit-sharded ``make_train_step``) and
``serve`` (``make_prefill_step``, then greedy ``make_serve_step`` decode
steps, with each device's addressable shard of the final cache).  The
port runs the same numpy params and inputs on a stacked CPU mesh of the
same shape.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from _multidev import run_with_devices
from repro_torch.configs import get_reduced
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import lm
from repro_torch.models import sharding as SHD
from repro_torch.train import shardings as SH
from repro_torch.train import step as TS
from repro_torch.weights import params_from_jax

RECIPE = dict(lr=8e-3, warmup_steps=2, total_steps=40)

REF = r"""
import dataclasses, json, numpy as np, jax, jax.numpy as jnp
from repro.configs import get_reduced
from repro.launch.mesh import make_local_mesh
from repro.models import lm
from repro.models.sharding import use_sharding
from repro.optim import adamw
from repro.train import shardings as SH
from repro.train import step as ST

tmp = {tmp!r}
cases = json.load(open(f"{{tmp}}/cases.json"))
inputs = np.load(f"{{tmp}}/inputs.npz")
recipe = json.loads({recipe!r})
def name(path):
    return "/".join(str(getattr(k, "key", getattr(k, "name",
                                                  getattr(k, "idx", k))))
                    for k in path)
def flat(tree):
    return {{name(p): np.asarray(l.astype(jnp.float32) if l.dtype ==
                                jnp.bfloat16 else l)
             for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}}
shapes = lambda t: jax.tree.map(
    lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), t)

for case in cases:
    cfg = get_reduced(case["arch"])
    if "remat" in case:
        cfg = dataclasses.replace(cfg, remat=case["remat"])
    dtype = jnp.bfloat16 if case["dtype"] == "bfloat16" else jnp.float32
    mesh = make_local_mesh(case["data"], case["model"])
    coord = {{d.id: np.argwhere(mesh.devices == d)[0]
              for d in mesh.devices.flat}}
    pcfg = ST.ParallelConfig(**case["pcfg"])
    params = lm.init_lm(cfg, jax.random.key(case["seed"]), dtype)
    out = {{f"param/{{k}}": v for k, v in flat(params).items()}}
    out["dtypes"] = np.array(json.dumps({{
        name(p): str(l.dtype)
        for p, l in jax.tree_util.tree_flatten_with_path(params)[0]}}))
    batch = {{k: jnp.asarray(inputs[f"{{case['name']}}/{{k}}"])
              for k in case["batch"]}}
    ps = SH.tree_shardings(params, mesh, SH.param_spec, fsdp=pcfg.fsdp)
    pd = jax.device_put(params, ps)
    if "forward" in case["kinds"]:
        def fwd(p, b):
            with use_sharding(mesh, ST.sharding_rules(pcfg)):
                lg, aux, _ = lm.forward(cfg, p, b["tokens"],
                                        positions=b.get("positions"),
                                        moe_groups=pcfg.moe_groups)
            return lg.astype(jnp.float32), aux
        lg, aux = jax.jit(fwd)(pd, batch)
        out["logits"], out["aux"] = np.asarray(lg), np.asarray(aux)
    if "train" in case["kinds"]:
        state = ST.TrainState(params, adamw.init(params),
                              jnp.zeros((), jnp.int32), None)
        _, compile_step, state_shardings = ST.make_train_step(
            cfg, mesh, pcfg, adamw.OptConfig(**recipe), donate=False)
        step = compile_step(shapes(state), shapes(batch))
        st, m = step(jax.device_put(state, state_shardings(shapes(state))),
                     batch)
        out["metrics"] = np.array([float(m[k]) for k in
                                   ("loss", "ce", "aux", "zloss",
                                    "grad_norm")])
        out.update({{f"p1/{{k}}": v for k, v in flat(st.params).items()}})
    if "serve" in case["kinds"]:
        toks = batch["tokens"]
        B, S = toks.shape
        pb = {{k: v for k, v in batch.items()
               if k in ("tokens", "enc_embeds")}}
        enc_len = pb["enc_embeds"].shape[1] if "enc_embeds" in pb else 0
        cache = lm.init_cache(cfg, B, case["max_len"], enc_len=enc_len)
        cs = SH.tree_shardings(cache, mesh, SH.cache_spec)
        _, pcomp = ST.make_prefill_step(cfg, mesh, pcfg)
        _, scomp = ST.make_serve_step(cfg, mesh, pcfg)
        pstep = pcomp(shapes(params), shapes(cache), shapes(pb))
        lg, cache = pstep(pd, jax.device_put(cache, cs), pb)
        out["prefill_logits"] = np.asarray(lg)
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        sstep = scomp(shapes(params), shapes(cache), shapes(tok))
        dec, got = [], [np.asarray(tok)]
        for i in range(case["steps"]):
            lg, cache = sstep(pd, cache, tok, jnp.asarray(S + i, jnp.int32))
            dec.append(np.asarray(lg))
            tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
            got.append(np.asarray(tok))
        out["decode_logits"] = np.stack(dec)
        out["greedy"] = np.concatenate(got, 1)
        for p, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
            out[f"cache/{{name(p)}}"] = np.asarray(leaf)
            for s in leaf.addressable_shards:
                i, j = coord[s.device.id]
                out[f"shard/{{name(p)}}@{{i}}_{{j}}"] = np.asarray(s.data)
    np.savez(f"{{tmp}}/{{case['name']}}.npz", **out)
print("REF_OK")
"""


def run_reference(cases, inputs, tmp, devices=4, timeout=560):
    """The reference's run of ``cases`` (dicts: name, arch, dtype, data,
    model, pcfg, seed, batch keys, kinds, for serve max_len and steps, and
    optionally remat, the config's override) over ``inputs`` ({case
    name/key: array}; an enc-dec serve case's prefill takes its
    ``enc_embeds``); {case name: its arrays}."""
    tmp = Path(tmp)
    with open(tmp / "cases.json", "w") as f:
        json.dump(cases, f)
    np.savez(tmp / "inputs.npz", **inputs)
    out = run_with_devices(REF.format(tmp=str(tmp),
                                      recipe=json.dumps(RECIPE)),
                           devices, timeout=timeout)
    assert "REF_OK" in out
    return {c["name"]: dict(np.load(tmp / f"{c['name']}.npz"))
            for c in cases}


def nest(flat: dict, prefix: str) -> dict:
    """{prefix + "a/b": x} to nested dicts."""
    out = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = out
        *head, last = k[len(prefix):].split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def port_params(ref: dict):
    """The case's reference params as the port's, each leaf in the
    reference's dtype (bf16 leaves were saved as their exact f32)."""
    p = params_from_jax(nest(ref, "param/"), device="cpu")
    dtypes = json.loads(str(ref["dtypes"]))
    return SH.tree_map(lambda path, x: x.to(getattr(
        torch, dtypes[SH._path_str(path)])), p, with_path=True)


def batch_of(inputs: dict, case: dict) -> dict:
    return {k: torch.from_numpy(inputs[f"{case['name']}/{k}"])
            for k in case["batch"]}


def mesh_forward(cfg, pcfg, mesh, params, batch):
    """``lm.forward`` over a stacked mesh in the split compute (the mesh
    train step's forward, without grad): (full logits f32, aux of device
    0)."""
    ps = SH.tree_shardings(params, mesh, SH.param_spec, fsdp=pcfg.fsdp)
    bs = SH.batch_specs(mesh, batch)
    axes = TS._batch_axes(mesh, bs)
    lg = TS._logits_sharding(cfg, mesh, batch["tokens"].shape[0])
    with torch.no_grad(), SHD.use_sharding(mesh, TS.sharding_rules(pcfg),
                                           batch_axes=axes):
        full = TS.compute_params(cfg, mesh, SH.shard(params, ps), ps, axes)
        b = SH.tree_map(TS._fold, SH.shard(batch, bs), bs)
        logits, aux, _ = lm.forward(cfg, full, b["tokens"],
                                    positions=b.get("positions"),
                                    enc_embeds=b.get("enc_embeds"),
                                    moe_groups=pcfg.moe_groups)
        out = TS._logits_out(logits.float(), lg, mesh, cfg.vocab_size)
    aux = aux.reshape(-1)[0]
    return SH.unshard({"l": out}, {"l": lg})["l"], aux


def mesh_train(cfg, pcfg, mesh, params, batch):
    """One step of the port's mesh train step from step 0: (metrics,
    full params after it, the mesh's hop and reduction counts)."""
    from repro_torch.optim import adamw
    state = TS.state_from_params(params, pcfg)
    _, compile_step, state_shardings = TS.make_train_step(
        cfg, mesh, pcfg, adamw.OptConfig(**RECIPE))
    sh = state_shardings(state)
    step = compile_step(state, batch)
    mesh.reset_counts()
    st, m = step(SH.shard(state, sh), batch)
    counts = mesh.counts()
    return m, SH.unshard(st, sh).params, counts


def cfg_of(case):
    cfg = get_reduced(case["arch"])
    if "remat" in case:
        cfg = dataclasses.replace(cfg, remat=case["remat"])
    return cfg


def mesh_of(case):
    return make_local_mesh(case["data"], case["model"], device="cpu")


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)
