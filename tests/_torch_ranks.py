"""The port's multi-device jobs, run over a StackedAxis in the test
process and over a GroupAxis on gloo ranks spawned here.

A job is ``job(axis, local, shared) -> {name: tensor}``: ``local`` holds
the inputs with the axis's local devices on dim 0 (all n of them on a
StackedAxis, the rank's one on a GroupAxis), ``shared`` the inputs every
device sees whole (page tables), and every output carries the local
devices on dim 0.  ``run_gloo`` starts one process a rank
(``python _torch_ranks.py JOB RANK N PORT DIR``, gloo over
``tcp://127.0.0.1:PORT``, the env torchrun would set), each loading the
inputs from DIR and writing its outputs there, and stacks the ranks'
outputs on dim 0, so both runs give the same shapes.

Imports torch, numpy and the port only: a rank never imports jax.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"


# ---------------------------------------------------------------------------
# the jobs
# ---------------------------------------------------------------------------

def rbm_cases(n: int) -> dict:
    """Each case of the rbm job at axis size n: name -> (function of
    ``rbm``, its arguments before the axis, its keywords, the input key).
    The reference's run reads the same table (its ``axis`` keyword is the
    port's ``dim``), and its outputs carry the same names."""
    wrap = {8: [(2, 6), (6, 2), (0, 7), (7, 1)],
            4: [(0, 2), (3, 1), (0, 3), (3, 0), (1, 1)]}[n]
    line = {8: [(1, 6), (6, 1), (7, 0)], 4: [(0, 3), (3, 0)]}[n]
    src, dsts = {8: (3, [0, 5, 7]), 4: (1, [3])}[n]
    cases = {"hop_+1": ("rbm_hop", [], {"step": 1}, "x"),
             "hop_-1": ("rbm_hop", [], {"step": -1}, "x")}
    for s, d in wrap:
        cases[f"copy_{s}_{d}"] = ("lisa_copy", [s, d], {}, "x")
    for s, d in line:
        cases[f"chain_{s}_{d}"] = ("lisa_copy", [s, d],
                                   {"wraparound": False}, "x")
    cases["bcast_some"] = ("lisa_broadcast", [src], {"dsts": dsts}, "x")
    cases["bcast_all"] = ("lisa_broadcast", [src], {}, "x")
    cases["allgather_0"] = ("ring_allgather", [], {}, "x")
    cases["allgather_1"] = ("ring_allgather", [], {"dim": 1}, "x")
    cases["reduce_scatter"] = ("ring_reduce_scatter", [], {}, "rs")
    cases["allreduce"] = ("ring_allreduce", [], {}, "ar")
    return cases


def rbm_job(axis, local, shared):
    from repro_torch.core.lisa import compression as C
    from repro_torch.core.lisa import rbm
    out = {}
    for name, (fn, pre, kw, key) in rbm_cases(axis.size).items():
        out[name] = getattr(rbm, fn)(local[key], *pre, axis, **kw)
    out["matmul"] = rbm.ring_allgather_matmul(local["mx"], local["mw"], axis)
    mean, err = C.allreduce_mean_compressed(local["g"],
                                            torch.zeros_like(local["g"]),
                                            axis)
    out["compressed_mean"], out["compressed_err"] = mean, err
    # a ring_scan makes n hops and nothing else: no reduction, and the
    # axis has no all-gather of its own to call
    axis.reset_counts()
    rbm.ring_scan(local["x"], axis, lambda acc, buf, src: acc + buf,
                  torch.zeros_like(local["x"]))
    out["scan_counts"] = torch.tensor([[axis.hops, axis.reductions]]
                                      * axis.n_local)
    return out


def ring_attention_job(axis, local, shared):
    from repro_torch.core.lisa.ring_attention import ring_attention
    out = {}
    for causal in (True, False):
        axis.reset_counts()
        out[f"causal_{causal}"] = ring_attention(
            local["q"], local["k"], local["v"], axis, causal=causal)
        out[f"counts_{causal}"] = torch.tensor(
            [[axis.hops, axis.reductions]] * axis.n_local)
    return out


def pipeline_job(axis, local, shared):
    from repro_torch.train.pipeline import pipeline_transformer

    def layer_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"].unsqueeze(-2))

    run = pipeline_transformer(axis, layer_fn, int(shared["l_per"]))
    axis.reset_counts()
    got = run({"w": local["w"], "b": local["b"]}, local["micro"])
    n = axis.size
    return {"out": got,
            "counts": torch.tensor([[axis.hops, axis.reductions]]
                                   * axis.n_local),
            "slots": torch.tensor([[n + local["micro"].shape[1] - 1]]
                                  * axis.n_local)}


def mesh_movement_job(axis, local, shared):
    """The reference's migration (0 -> 2) and cross-replica fork (1 -> 3)
    plans over the axis, each into its own copy of the pools."""
    from repro_torch import movement as MV
    from repro_torch.core.lisa.topology import MeshTopology
    out = {}
    for name, kind, src, dst in (("migration", "move", 0, 2),
                                 ("fork", "fork", 1, 3)):
        st, dt = shared[f"{name}_src"], shared[f"{name}_dst"]
        plan = MV.plan(MV.Transfer(
            MV.Tier("slow", index=src, axis=axis.name),
            MV.Tier("slow", index=dst, axis=axis.name),
            MV.Layout.raw_pages(len(st), 8, 128, np.uint8), kind=kind),
            topo=MeshTopology(axis.size))
        pool = local["pool"].clone()
        axis.reset_counts()
        env = MV.execute(plan, src_pool=pool, src_table=st, dst_pool=pool,
                         dst_table=dt, axes={axis.name: axis})
        out[name] = env["dst_pool"]
        out[f"{name}_hops"] = torch.tensor([[axis.hops]] * axis.n_local)
    return out


def raises_job(axis, local, shared):
    """The loud errors of a gloo group: a CUDA axis on it, and a tensor on
    another device than the axis's."""
    from repro_torch.launch.mesh import GroupAxis
    got = []
    try:
        GroupAxis(axis.group, device="cuda")
    except ValueError as e:
        got.append("nccl" in str(e))
    try:
        axis.ppermute(torch.zeros((1, 4), device="meta"), [(0, 1)])
    except ValueError as e:
        got.append("lives on cpu" in str(e))
    return {"raised": torch.tensor([got])}


MESH_TRAIN_STEPS = 3


def mesh_train_job(axis, local, shared):
    """Reduced tinyllama trained MESH_TRAIN_STEPS steps on a 2 x 2 mesh
    (fsdp, tensor_parallel; then saved with its shardings and restored):
    on ranks ``Mesh.from_env``, on a stack ``make_local_mesh``, from the
    full params and batches in ``shared`` (keys ``param/<path>``,
    ``tokens@<i>``, ``labels@<i>``, and ``ckpt_dir``); then the launcher
    with ``--data 2 --model 2`` (on ranks under torchrun's env, which
    ``_rank_main`` sets)."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import GroupAxis, Mesh, make_local_mesh
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import shardings as SH
    from repro_torch.train import step as TS
    mesh = (Mesh.from_env(2, 2, device="cpu") if isinstance(axis, GroupAxis)
            else make_local_mesh(2, 2, device="cpu"))
    cfg = get_reduced("tinyllama-1.1b")
    pcfg = TS.ParallelConfig(fsdp=True)
    params = {}
    for k, v in shared.items():
        if k.startswith("param/"):
            node = params
            *head, last = k[len("param/"):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = torch.from_numpy(v)
    state = TS.state_from_params(params, pcfg)
    batches = [{k: torch.from_numpy(shared[f"{k}@{i}"])
                for k in ("tokens", "labels")}
               for i in range(MESH_TRAIN_STEPS)]
    _, compile_step, state_shardings = TS.make_train_step(
        cfg, mesh, pcfg, OptConfig(lr=8e-3, warmup_steps=2, total_steps=40))
    sh = state_shardings(state)
    step = compile_step(state, batches[0])
    st = SH.shard(state, sh)
    hist, counts = [], []
    for b in batches:
        mesh.reset_counts()
        st, m = step(st, b)
        hist.append([float(m["loss"]), float(m["grad_norm"])])
        counts.append([c for a in ("data", "model")
                       for c in mesh.counts()[a]])
    d = str(shared["ckpt_dir"])
    ckpt.save(st, d, MESH_TRAIN_STEPS, shardings=sh)
    back = ckpt.restore(state, d, shardings=sh)
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(ckpt._flatten(st), ckpt._flatten(back)))
    from repro_torch.launch import train as launch_train
    launched = launch_train.run(
        ["--device", "cpu", "--arch", "tinyllama-1.1b", "--reduced",
         "--steps", "4", "--batch", "4", "--seq", "32", "--data", "2",
         "--model", "2"])[2]["losses"]
    out = {f"shard/{p}": leaf for p, leaf in ckpt._flatten(st.params)}
    n = mesh.n_local
    out.update(hist=torch.tensor([hist] * n, dtype=torch.float64),
               launcher=torch.tensor([launched] * n, dtype=torch.float64),
               counts=torch.tensor([counts] * n),
               restored=torch.tensor([same] * n))
    return out


def _mesh_22(axis):
    """A 2 x 2 mesh: on ranks ``Mesh.from_env``, on a stack
    ``make_local_mesh``."""
    from repro_torch.launch.mesh import GroupAxis, Mesh, make_local_mesh
    return (Mesh.from_env(2, 2, device="cpu") if isinstance(axis, GroupAxis)
            else make_local_mesh(2, 2, device="cpu"))


def _shared_params(shared):
    params = {}
    for k, v in shared.items():
        if k.startswith("param/"):
            node = params
            *head, last = k[len("param/"):].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = torch.from_numpy(v)
    return params


def tp_train_job(axis, local, shared):
    """Reduced tinyllama, 2 steps on a 2 x 2 mesh with tensor and sequence
    parallelism, from the full params (``param/<path>``) and batches
    (``tokens``/``labels`` (2, B, S)) in ``shared``."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_reduced
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import shardings as SH
    from repro_torch.train import step as TS
    mesh = _mesh_22(axis)
    cfg = get_reduced("tinyllama-1.1b")
    pcfg = TS.ParallelConfig(sequence_parallel=True)
    state = TS.state_from_params(_shared_params(shared), pcfg)
    batches = [{k: torch.from_numpy(shared[k][i].copy())
                for k in ("tokens", "labels")} for i in range(2)]
    _, compile_step, state_shardings = TS.make_train_step(
        cfg, mesh, pcfg, OptConfig(lr=8e-3, warmup_steps=2, total_steps=40))
    sh = state_shardings(state)
    step = compile_step(state, batches[0])
    st = SH.shard(state, sh)
    hist, counts = [], []
    for b in batches:
        mesh.reset_counts()
        st, m = step(st, b)
        hist.append([float(m["loss"]), float(m["grad_norm"])])
        counts.append([c for a in ("data", "model")
                       for c in mesh.counts()[a]])
    out = {f"shard/{p}": leaf for p, leaf in ckpt._flatten(st.params)}
    n = mesh.n_local
    out.update(hist=torch.tensor([hist] * n, dtype=torch.float64),
               counts=torch.tensor([counts] * n))
    return out


def tp_serve_job(axis, local, shared):
    """Reduced ``shared["arch"]``'s prefill of ``tokens`` (B, S) and
    ``steps`` greedy decode steps on a 2 x 2 mesh (tensor parallel) over
    a laid-out cache of ``max_len``: every step's laid-out logits, the
    greedy tokens, the laid-out cache and the counts."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.train import shardings as SH
    from repro_torch.train import step as TS
    mesh = _mesh_22(axis)
    cfg = get_reduced(str(shared["arch"]))
    pcfg = TS.ParallelConfig()
    params = _shared_params(shared)
    toks = torch.from_numpy(shared["tokens"])
    B, S = toks.shape
    cache = lm.init_cache(cfg, B, int(shared["max_len"]), device="cpu")
    _, pcomp = TS.make_prefill_step(cfg, mesh, pcfg)
    _, scomp = TS.make_serve_step(cfg, mesh, pcfg)
    batch = {"tokens": toks}
    ps = SH.tree_shardings(params, mesh, SH.param_spec)
    cs = SH.tree_shardings(cache, mesh, SH.cache_spec)
    laid_p = SH.shard(params, ps)
    laid_c = SH.shard(cache, cs, stack_dim=1)
    mesh.reset_counts()
    lg, laid_c = pcomp(params, cache, batch)(laid_p, laid_c, batch)
    out = {"prefill": lg}
    lg_sh = TS._logits_sharding(cfg, mesh, B)
    tok = SH.unshard({"l": lg}, {"l": lg_sh})["l"][:, -1].argmax(-1)
    tok = tok[:, None].to(torch.int32)
    sstep = scomp(params, cache, tok)
    got = [tok]
    for i in range(int(shared["steps"])):
        lg, laid_c = sstep(laid_p, laid_c, tok, S + i)
        out[f"decode{i}"] = lg
        tok = SH.unshard({"l": lg}, {"l": lg_sh})["l"][:, -1].argmax(-1)
        tok = tok[:, None].to(torch.int32)
        got.append(tok)
    n = mesh.n_local
    out.update({f"cache/{p}": leaf.contiguous()
                for p, leaf in ckpt._flatten(laid_c)})
    out["greedy"] = torch.cat(got, 1)[None].expand(n, -1, -1).contiguous()
    out["counts"] = torch.tensor([[c for a in ("data", "model")
                                   for c in mesh.counts()[a]]] * n)
    return out


JOBS = {"rbm": rbm_job, "ring_attention": ring_attention_job,
        "pipeline": pipeline_job, "mesh_movement": mesh_movement_job,
        "raises": raises_job, "mesh_train": mesh_train_job,
        "tp_train": tp_train_job, "tp_serve": tp_serve_job}


# ---------------------------------------------------------------------------
# the two runs
# ---------------------------------------------------------------------------

def _tensors(arrays: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in arrays.items()}


def run_stacked(job: str, n: int, local: dict, shared: dict) -> dict:
    """``job`` over ``StackedAxis(n, device="cpu")``, as numpy arrays."""
    from repro_torch.launch.mesh import StackedAxis
    axis = StackedAxis(n, device="cpu", name="x")
    got = JOBS[job](axis, _tensors(local), shared)
    return {k: v.numpy() for k, v in got.items()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_gloo(jobs, n: int, local: dict, shared: dict, tmp: Path,
             timeout: int = 240) -> dict:
    """Each of ``jobs`` on n gloo ranks, one process a rank started
    together: {job: {name: the ranks' outputs stacked on dim 0}}."""
    tmp = Path(tmp)
    np.savez(tmp / "local.npz", **local)
    np.savez(tmp / "shared.npz", **shared)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(SRC), str(HERE), os.environ.get("PYTHONPATH", "")]),
        "OMP_NUM_THREADS": "1"}
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_ranks.py"), ",".join(jobs),
         str(r), str(n), str(port), str(tmp)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    outs = {}
    for job in jobs:
        ranks = [np.load(tmp / f"{job}_rank{r}.npz") for r in range(n)]
        outs[job] = {k: np.concatenate([z[k] for z in ranks])
                     for k in ranks[0].files}
    return outs


def _rank_main(jobs: str, rank: int, n: int, port: int, tmp: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import GroupAxis
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    axis = GroupAxis.from_env(device="cpu", name="x")
    try:
        with np.load(Path(tmp) / "local.npz") as z:
            local = {k: z[k][rank:rank + 1] for k in z.files}
        with np.load(Path(tmp) / "shared.npz") as z:
            shared = {k: z[k] for k in z.files}
        for job in jobs.split(","):
            got = JOBS[job](axis, _tensors(local), shared)
            np.savez(Path(tmp) / f"{job}_rank{rank}.npz",
                     **{k: v.numpy() for k, v in got.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    try:
        _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                   int(sys.argv[4]), sys.argv[5])
    except BaseException:
        traceback.print_exc()
        raise
