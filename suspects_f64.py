"""Hold a mesh run and the single-device run of the same weights each to
an f64 run on the CPU, to tell the mesh's rounding from a fault.

    python3 suspects_f64.py olmoe|rwkv6

Needs one CUDA card.  ``olmoe``: olmoe-1b-7b at full width, cut to the
first RUNS["olmoe"] layers, on the 1 x 4 stacked mesh (heads and experts
over model, as chip_smoke.py's phase 23 serves it); ``rwkv6``: rwkv6-7b at
full width, cut likewise, on 1 x 2 (phase 24).  Random f32 weights from
chip_smoke.SEED.  Each run prefills BATCH prompts of PROMPT tokens into a
cache of MAX_LEN slots, then takes STEPS decode steps, teacher-forced on
the single device's greedy tokens and, in an MoE layer, on its expert
choices (chip_smoke.Routes), so that the three runs sum the same terms:
the single device's ``lm.prefill``/``decode_step``; the mesh's
``make_prefill_step``/``make_serve_step`` over a laid-out cache; and the
same model code on the CPU with every weight, the cache and every float the
code widens (``Tensor.float``, patched for that run) in f64.  The depth is
cut so that the f64 weights fit the host's memory.  Prints each run's
relative L2 gap and largest gap to the f64 logits, the mesh's to the single
device's, and the verdict: rounding where the mesh's relative L2 gap to f64
is at most RATIO times the single device's, else a fault.  The last line
is one JSON object.
"""
from __future__ import annotations

import dataclasses
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (arch, mesh, layers): each cut to what the host holds in f64 (olmoe's 8
# layers 28.5 GB, rwkv6's 16 layers ~30 GB) beside the run itself
RUNS = {"olmoe": ("olmoe-1b-7b", (1, 4), 8),
        "rwkv6": ("rwkv6-7b", (1, 2), 16)}
BATCH, PROMPT, MAX_LEN, STEPS = 4, 64, 128, 8
RATIO = 2.0


def mesh_serve(cfg, params, toks, fed, shape, force):
    """The mesh's prefill and decode logits, fed ``fed`` and routed as
    ``force`` says."""
    import torch
    import chip_smoke as cs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.train import shardings as SH
    from repro_torch.train import step as TS

    dev = toks.device
    pcfg = TS.ParallelConfig()
    mesh = make_local_mesh(*shape, device=dev)
    like = lm.init_cache(cfg, BATCH, MAX_LEN, device="meta")
    _, pcomp = TS.make_prefill_step(cfg, mesh, pcfg)
    _, scomp = TS.make_serve_step(cfg, mesh, pcfg)
    lg_sh = TS._logits_sharding(cfg, mesh, BATCH)
    laid_p = SH.shard(params, SH.tree_shardings(params, mesh, SH.param_spec))
    laid_c = SH.shard(lm.init_cache(cfg, BATCH, MAX_LEN, device=dev),
                      SH.tree_shardings(like, mesh, SH.cache_spec),
                      stack_dim=1)
    batch = {"tokens": toks}
    pstep = pcomp(params, like, batch)
    sstep = scomp(params, like, toks[:, :1])
    outs = []
    with cs.Routes(cfg.n_experts, force=force, mesh=mesh):
        lg, laid_c = pstep(laid_p, laid_c, batch)
        outs.append(SH.unshard({"l": lg}, {"l": lg_sh})["l"])
        for i in range(STEPS):
            lg, laid_c = sstep(laid_p, laid_c, fed[i], PROMPT + i)
            outs.append(SH.unshard({"l": lg}, {"l": lg_sh})["l"])
    del laid_p, laid_c
    return outs


def f64_serve(cfg, params, toks, fed, force):
    """The same prefill and steps on the CPU in f64."""
    import torch
    import chip_smoke as cs
    from repro_torch.models import lm
    from repro_torch.train import shardings as SH

    p64 = SH.tree_map(lambda t: t.detach().to("cpu", torch.float64), params)
    cache = SH.tree_map(
        lambda t: t.double() if t.is_floating_point() else t,
        lm.init_cache(cfg, BATCH, MAX_LEN, device="cpu"))
    force = None if force is None else [(p.cpu(), i.cpu()) for p, i in force]
    widen = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **kw: self.double()
    try:
        with cs.Routes(cfg.n_experts, force=force):
            logits, _ = lm.prefill(cfg, p64, toks.cpu(), cache)
            outs = [logits]
            for i in range(STEPS):
                lg, _ = lm.decode_step(cfg, p64, cache, fed[i].cpu(),
                                       PROMPT + i)
                outs.append(lg)
    finally:
        torch.Tensor.float = widen
    check = {str(t.dtype) for t in outs}
    if check != {"torch.float64"}:
        raise RuntimeError(f"the f64 run's logits came out as {check}")
    return outs


def gap(got, want) -> tuple:
    """(relative L2 gap, largest gap) of a run's logits to ``want``'s."""
    num = den = 0.0
    worst = 0.0
    for a, b in zip(got, want):
        d = a.detach().double().cpu() - b.double().cpu()
        num += float((d * d).sum())
        den += float((b.double().cpu() ** 2).sum())
        worst = max(worst, float(d.abs().max()))
    return math.sqrt(num / den), worst


def main(argv=None) -> int:
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config

    name = (argv or sys.argv[1:])[0]
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this runs on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch, shape, layers = RUNS[name]
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    tag = cs.card()
    print(f"{name}: {arch} at full width, {layers} of {full.n_layers} "
          f"layers, on {shape[0]} x {shape[1]} [{tag}]", flush=True)
    dev = torch.device("cuda")
    params = cs.model_params(cfg, torch.float32, arch,
                             f"{layers} layers: their f64 copy fits the "
                             f"host")
    toks = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device=dev,
                         dtype=torch.int32, generator=torch.Generator(
                             device=dev).manual_seed(cs.SEED + 23))
    moe = "moe" in cfg.mlp_kinds()
    t0 = time.perf_counter()
    with cs.Routes(cfg.n_experts) as routes:
        pre, steps, fed = cs.single_serve(cfg, params, toks, MAX_LEN, STEPS)
    single = [pre] + steps
    force = routes.calls if moe else None
    print(f"single device: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    mesh = mesh_serve(cfg, params, toks, fed, shape, force)
    print(f"mesh: {time.perf_counter() - t0:.1f} s", flush=True)
    single = [t.cpu() for t in single]
    mesh = [t.cpu() for t in mesh]
    t0 = time.perf_counter()
    truth = f64_serve(cfg, params, toks, fed, force)
    print(f"f64 on the CPU: {time.perf_counter() - t0:.1f} s", flush=True)
    del params
    s_rel, s_max = gap(single, truth)
    m_rel, m_max = gap(mesh, truth)
    sm_rel, sm_max = gap(mesh, single)
    verdict = "rounding" if m_rel <= RATIO * s_rel else "fault"
    print(f"{name}: relative L2 gap to f64: single device {s_rel:.4g} "
          f"(largest {s_max:.4g}), mesh {m_rel:.4g} (largest {m_max:.4g}); "
          f"mesh to single device {sm_rel:.4g} (largest {sm_max:.4g}); "
          f"mesh / single device {m_rel / s_rel:.3f} against {RATIO}: "
          f"{verdict} [{tag}]")
    print(json.dumps({"run": name, "arch": arch, "layers": layers,
                      "mesh": list(shape), "single_rel": s_rel,
                      "single_max": s_max, "mesh_rel": m_rel,
                      "mesh_max": m_max, "mesh_to_single_rel": sm_rel,
                      "mesh_to_single_max": sm_max, "verdict": verdict,
                      "card": tag}))
    return 0 if verdict == "rounding" else 1


if __name__ == "__main__":
    sys.exit(main())
