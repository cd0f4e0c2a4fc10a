# Port of src/repro/launch/dryrun.py in torch.  The reference lowers and
# compiles each cell over 512 forced host devices; the port has no compiler,
# so it lays each cell out on a mesh with no devices and counts its cost.
"""Multi-pod dry run: lay out every (arch x shape x mesh) cell and cost it.

For each cell:
  * the production mesh as a layout (``launch/mesh.py``:
    ``make_production_mesh``, 16 x 16 single-pod, 2 x 16 x 16 multi-pod;
    no devices),
  * every leaf of the params, AdamW state, cache and batch as a meta
    tensor (``launch/specs.py``), laid out by ``train/shardings.py``'s
    specs: the bytes each device holds, and whether they fit in the
    card's 80 GB;
  * the step's flops, counted over its plain path on the meta device
    (``roofline/cost.py``; the per-device figure is the program's over the
    chips, the compute taken as split evenly), and ``model_flops``;
  * the step's collective bytes a device, by the stated formulas of
    ``roofline/cost.py``: the FSDP gathers (again under remat) and
    gradient reduce-scatters and all-reduces over the axes' rings
    (``mesh_step_link_bytes``), and the reductions, the model axis's
    activation all-reduces among them (``mesh_step_reduction_bytes``); a
    serving step gathers its params once and reduces its forward's
    activations;
  * the three-term roofline (``roofline/analysis.py``) at the card's
    peaks, its collective term at NVLink's rate,

and writes the JSON artifact under ``experiments/dryrun_torch/``, with
the reference's keys where they mean something (``hlo_cost`` holds the
cost model's numbers, so ``roofline/report.py`` renders both packages'
artifacts; ``compile_s`` is the seconds the cell took to lay out and
count).

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --all            # every applicable cell
Variants: --no-fsdp --no-tp --sp --grad-compress --no-remat
  --cache-dtype bf16|f32 --variant NAME
"""
import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def _local_bytes(tree, shardings) -> int:
    from repro_torch.train import shardings as SH
    total = [0]

    def add(x, sh):
        total[0] += math.prod(sh.local_shape(x.shape)) * x.element_size()
    SH.tree_map(add, tree, shardings)
    return total[0]


def _compute_bytes(params, shardings, mesh) -> int:
    """The weights as the compute holds them: gathered over every axis but
    ``model``, split over ``model`` as stored."""
    from repro_torch.train import shardings as SH
    total = [0]

    def add(x, sh):
        shape = list(x.shape)
        for d, names in sh.dims():
            if "model" in names:
                shape[d] //= mesh.shape["model"]
        total[0] += math.prod(shape) * x.element_size()
    SH.tree_map(add, params, shardings)
    return total[0]


RECURRENT = ("mamba", "rwkv", "rwkv_cm")
FIT_LENGTHS = (64, 128, 256)


def _count(cfg, shape, pcfg, seq: int):
    """The cost model's count of one step of ``cfg`` at ``shape``'s kind
    and batch over ``seq`` tokens (a decode step: one token over a
    ``seq``-slot cache), every tensor on the meta device.  The plain
    attention scores every pair of its blocks; with one block of the whole
    length (``attn_block = seq``) it scores the same pairs as with the
    config's 512 (every length here is a multiple of it) in far fewer
    ops."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import specs as SP
    from repro_torch.models import lm
    from repro_torch.roofline import cost as C
    from repro_torch.train import step as TS

    cfg = dataclasses.replace(cfg, attn_block=max(seq, 1))
    sh = ShapeConfig(name=f"{shape.name}@{seq}", kind=shape.kind,
                     seq_len=seq, global_batch=shape.global_batch)
    batch = SP.input_specs(cfg, sh)
    if shape.kind == "train":
        params = SP.param_specs(cfg, param_dtype=torch.bfloat16)
        return C.count_flops(TS.grads_of, cfg, pcfg, params, batch)
    params = SP.param_specs(cfg, param_dtype=torch.bfloat16)
    if shape.kind == "prefill":
        # an enc-dec prefill writes its frames' K/V: a cache of as many
        # (the reference's specs size every enc-dec cache for decode)
        cache = lm.init_cache(cfg, shape.global_batch, max_len=seq,
                              enc_len=seq if cfg.encdec else 0,
                              dtype=torch.bfloat16, device=SP.META)
        return C.count_flops(lm.prefill, cfg, params, batch["tokens"], cache,
                             positions=batch.get("positions"),
                             enc_embeds=batch.get("enc_embeds"))
    cache = SP.cache_specs(cfg, sh)
    return C.count_flops(lm.decode_step, cfg, params, cache, batch["tokens"],
                         batch["pos"])


def cell_flops(cfg, shape, pcfg) -> dict:
    """The step's flops (the whole program, every chip's), counted at the
    cell's length; where the model scans recurrent layers a token at a time
    and the step runs its whole sequence (train, prefill), counted at the
    three lengths of :data:`FIT_LENGTHS` and carried to the cell's by the
    quadratic through them (attention's pairs grow as the length squared,
    everything else linearly: the fit is exact)."""
    from fractions import Fraction

    if shape.kind == "decode" or not any(
            k in RECURRENT for k in cfg.layer_kinds()):
        got = _count(cfg, shape, pcfg, shape.seq_len)
        got["counted_at"] = [shape.seq_len]
        return got
    xs = FIT_LENGTHS
    ys = [_count(cfg, shape, pcfg, n)["flops"] for n in xs]
    total = Fraction(0)
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        term = Fraction(yi)
        for j, xj in enumerate(xs):
            if j != i:
                term *= Fraction(shape.seq_len - xj, xi - xj)
        total += term
    return {"flops": int(total), "by_op": {}, "counted_at": list(xs)}


def run_cell(args) -> dict:
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import applicable_shapes
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline import analysis as RA
    from repro_torch.roofline import cost as C
    from repro_torch.train import shardings as SH
    from repro_torch.train import step as TS

    cfg = get_config(args.arch)
    if args.no_remat:
        cfg = dataclasses.replace(cfg, remat=False)
    shape = SHAPES[args.shape]
    if args.shape not in applicable_shapes(cfg):
        return {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
                "variant": args.variant, "status": "skipped",
                "reason": "long_500k needs sub-quadratic attention "
                          "(DESIGN.md Sec. 4)"}
    mesh = make_production_mesh(multi_pod=args.mesh == "multi")
    n_chips = int(mesh.devices.size)
    pcfg = TS.ParallelConfig(fsdp=not args.no_fsdp,
                             tensor_parallel=not args.no_tp,
                             sequence_parallel=args.sp,
                             grad_compress=args.grad_compress)
    cache_dtype = {"bf16": torch.bfloat16,
                   "f32": torch.float32}[args.cache_dtype]
    B, S = shape.global_batch, shape.seq_len
    t0 = time.perf_counter()
    memory = {"params_bytes": 0, "opt_state_bytes": 0, "cache_bytes": 0,
              "batch_bytes": 0}
    if shape.kind == "train":
        state = SP.state_specs(cfg, pcfg, param_dtype=torch.bfloat16)
        batch = SP.input_specs(cfg, shape)
        _, _, state_shardings = TS.make_train_step(cfg, mesh, pcfg)
        ss = state_shardings(state)
        params, psh = state.params, ss.params
        dp = ("pod", "data") if pcfg.tensor_parallel else \
            ("pod", "data", "model")
        bs = SH.batch_specs(mesh, batch, dp_axes=dp)
        batch_axes = TS._batch_axes(mesh, bs)
        memory["params_bytes"] = _local_bytes(state.params, ss.params)
        memory["opt_state_bytes"] = (
            _local_bytes(state.opt.m, ss.opt.m)
            + _local_bytes(state.opt.v, ss.opt.v)
            + (0 if state.err_fb is None else
               _local_bytes(state.err_fb, ss.err_fb)))
        counted = cell_flops(cfg, shape, pcfg)
        kinds = {}
        hops = C.mesh_step_link_bytes(params, psh, mesh, batch_axes, pcfg,
                                      cfg, kinds=kinds)
        reds = C.mesh_step_reduction_bytes(params, psh, mesh, batch_axes,
                                           pcfg, cfg, B, S)
        # each step reads and writes the state and reads the batch
        moved = 2 * (memory["params_bytes"] + memory["opt_state_bytes"])
    else:
        params = SP.param_specs(cfg, param_dtype=torch.bfloat16)
        cache = SP.cache_specs(cfg, shape, cache_dtype=cache_dtype)
        batch = SP.input_specs(cfg, shape)
        psh = SH.tree_shardings(params, mesh, SH.param_spec,
                                fsdp=pcfg.fsdp)
        csh = SH.tree_shardings(cache, mesh, SH.cache_spec)
        bs = SH.batch_specs(mesh, batch)
        batch_axes = TS._batch_axes(mesh, bs)
        memory["params_bytes"] = _local_bytes(params, psh)
        memory["cache_bytes"] = _local_bytes(cache, csh)
        counted = cell_flops(cfg, shape, pcfg)
        serve = dataclasses.replace(cfg, remat=False)
        kinds = {}
        hops = C.mesh_step_link_bytes(params, psh, mesh, batch_axes, pcfg,
                                      serve, backward=False, kinds=kinds)
        reds = C.mesh_step_reduction_bytes(
            params, psh, mesh, batch_axes, pcfg, cfg, B,
            S if shape.kind == "prefill" else 1, backward=False)
        # the params and the cache read once, the cache written
        moved = memory["params_bytes"] + 2 * memory["cache_bytes"]
    memory["batch_bytes"] = _local_bytes(batch, bs)
    memory["argument_size_bytes"] = sum(memory.values())
    memory["temp_size_bytes"] = None
    memory["fits_80gb"] = memory["argument_size_bytes"] <= RA.HBM_BYTES
    compute_bytes = _compute_bytes(params, psh, mesh)
    nbytes = compute_bytes + moved + memory["batch_bytes"]
    flops = counted["flops"] / n_chips
    link = sum(hops.values()) + sum(reds.values())
    cost = {"flops": flops, "bytes": float(nbytes),
            "link_bytes_total": float(link),
            "compute_params_bytes": compute_bytes,
            "flops_global": counted["flops"], "by_op": counted["by_op"],
            "flops_counted_at": counted["counted_at"]}
    terms = RA.roofline_terms(cost, n_chips, cfg, shape,
                              collective_bw=RA.NVLINK_BW)
    collectives = {k: {"count": 0, "operand_bytes": 0.0,
                       "result_bytes": 0.0, "link_bytes": 0.0}
                   for k in COLLECTIVE_KINDS}
    for k, rec in kinds.items():
        collectives[k]["count"] = rec["count"]
        collectives[k]["link_bytes"] = float(rec["link_bytes"])
    collectives["all-reduce"]["link_bytes"] += float(sum(reds.values()))
    took = time.perf_counter() - t0
    return {
        "arch": args.arch, "shape": args.shape, "mesh": args.mesh,
        "variant": args.variant, "status": "ok", "n_chips": n_chips,
        "kind": shape.kind, "compile_s": round(took, 1),
        "hlo_cost": cost,
        "memory": memory,
        "collectives": collectives,
        "link_bytes_by_axis": {"hops": hops, "reductions": reds},
        "roofline": terms,
        "parallel": dataclasses.asdict(pcfg),
        "cache_dtype": args.cache_dtype,
    }


def _parser():
    p = argparse.ArgumentParser()
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--mesh", choices=["single", "multi"], default="single")
    p.add_argument("--all", action="store_true")
    p.add_argument("--out-dir", default="experiments/dryrun_torch")
    p.add_argument("--variant", default="baseline")
    p.add_argument("--no-fsdp", action="store_true")
    p.add_argument("--no-tp", action="store_true")
    p.add_argument("--sp", action="store_true")
    p.add_argument("--grad-compress", action="store_true")
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--cache-dtype", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--timeout", type=int, default=600)
    return p


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    if args.all:
        # one subprocess per cell, as the reference's
        from repro_torch.configs import ARCH_NAMES, get_config
        from repro_torch.configs.base import applicable_shapes
        cells = [(a, s, m)
                 for a in ARCH_NAMES
                 for s in applicable_shapes(get_config(a))
                 for m in ("single", "multi")]
        for a, s, m in cells:
            out = os.path.join(args.out_dir, f"{a}_{s}_{m}_{args.variant}.json")
            if os.path.exists(out):
                print(f"[skip] {out}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s, "--mesh", m,
                   "--out-dir", args.out_dir, "--variant", args.variant]
            print(f"[run ] {a} {s} {m}", flush=True)
            r = subprocess.run(cmd, timeout=args.timeout)
            if r.returncode != 0:
                with open(out, "w") as f:
                    json.dump({"arch": a, "shape": s, "mesh": m,
                               "variant": args.variant, "status": "failed",
                               "returncode": r.returncode}, f,
                              allow_nan=False)
        return

    art = run_cell(args)
    name = f"{args.arch}_{args.shape}_{args.mesh}_{args.variant}.json"
    path = os.path.join(args.out_dir, name)
    with open(path, "w") as f:
        json.dump(art, f, indent=1, allow_nan=False)
    print(json.dumps({k: art[k] for k in
                      ("arch", "shape", "mesh", "status") if k in art},
                     allow_nan=False))
    if art.get("status") == "ok":
        m = art["memory"]
        print(f"memory a device: params {m['params_bytes'] / 1e9:.2f} GB, "
              f"AdamW {m['opt_state_bytes'] / 1e9:.2f} GB, cache "
              f"{m['cache_bytes'] / 1e9:.2f} GB, batch "
              f"{m['batch_bytes'] / 1e9:.4f} GB; fits 80 GB: "
              f"{m['fits_80gb']}")
        print("flops=%.3e a device, bytes=%.3e, link_bytes=%.3e" % (
            art["hlo_cost"]["flops"], art["hlo_cost"]["bytes"],
            art["hlo_cost"]["link_bytes_total"]))
        r = art["roofline"]
        print("roofline: compute=%.4fs memory=%.4fs collective=%.4fs "
              "dominant=%s useful=%.3f frac=%.3f" % (
                  r["compute_s"], r["memory_s"], r["collective_s"],
                  r["dominant"], r["useful_flops_ratio"],
                  r["roofline_fraction"]))


if __name__ == "__main__":
    main()
