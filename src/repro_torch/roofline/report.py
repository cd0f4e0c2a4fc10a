# Port of src/repro/roofline/report.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""Render EXPERIMENTS.md tables from the dry-run artifacts.

  PYTHONPATH=src python -m repro_torch.roofline.report [--dir experiments/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

NOTE = {
    # one sentence per (dominant term) on what would move it down
    "compute_s": "compute-bound: gains come from larger per-chip tiles "
                 "(less TP for this size) and bf16 everywhere",
    "memory_s": "memory-bound: cut activation traffic (fused kernels, bf16 "
                "cotangents, less remat) or raise arithmetic intensity "
                "(bigger per-chip batch)",
    "collective_s": "collective-bound: reshard (less FSDP gather / EP "
                    "all-to-all payload), overlap rings with compute, or "
                    "compress payloads",
}


def load(dir_: str, variant: str = "baseline"):
    """Collect the ok dry-run cells.  Files open under a context manager
    (the old ``json.load(open(f))`` leaked the handle until GC), and a
    cell that fails to parse is SKIPPED with a warning rather than taking
    the whole report down — one corrupt artifact should cost one row."""
    cells = []
    for f in sorted(glob.glob(os.path.join(dir_, f"*_{variant}.json"))):
        try:
            with open(f) as fh:
                a = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            print(f"report: skipping {f}: {e}", file=sys.stderr)
            continue
        if not isinstance(a, dict):
            print(f"report: skipping {f}: not a JSON object",
                  file=sys.stderr)
            continue
        if a.get("status") == "ok":
            cells.append(a)
    return cells


def fmt_table(cells, mesh="single"):
    rows = []
    hdr = ("| arch | shape | compute s | memory s (xla/kernel) | coll s | "
           "dominant | MODEL_FLOPS | useful | frac | bottleneck note |")
    sep = "|" + "---|" * 10
    rows.append(hdr)
    rows.append(sep)
    for a in cells:
        if a["mesh"] != mesh:
            continue
        r = a["roofline"]
        dom = r["dominant_kernel"]
        rows.append(
            f"| {a['arch']} | {a['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.3f} / {r['memory_s_kernel']:.3f} | "
            f"{r['collective_s']:.4f} | {dom.replace('_s','')} | "
            f"{r['model_flops']:.2e} | {r['useful_flops_ratio']:.3f} | "
            f"{r['roofline_fraction_kernel']:.4f} | {NOTE[dom]} |")
    return "\n".join(rows)


def fmt_dryrun_summary(cells):
    rows = ["| arch | shape | mesh | chips | compile s | HLO GF/chip | "
            "HBM GB/chip | link GB/chip | collectives (ag/ar/rs/a2a/cp) | "
            "args GB/chip | temp GB/chip |",
            "|" + "---|" * 11]
    for a in cells:
        c = a["collectives"]
        counts = "/".join(str(int(c[k]["count"])) for k in
                          ("all-gather", "all-reduce", "reduce-scatter",
                           "all-to-all", "collective-permute"))
        mem = a["memory"]
        arg = (mem.get("argument_size_bytes") or 0) / 1e9
        tmp = (mem.get("temp_size_bytes") or 0) / 1e9
        rows.append(
            f"| {a['arch']} | {a['shape']} | {a['mesh']} | {a['n_chips']} | "
            f"{a['compile_s']:.0f} | {a['hlo_cost']['flops']/1e9:.1f} | "
            f"{a['hlo_cost']['bytes']/1e9:.1f} | "
            f"{a['hlo_cost']['link_bytes_total']/1e9:.2f} | {counts} | "
            f"{arg:.2f} | {tmp:.2f} |")
    return "\n".join(rows)


def pick_hillclimb(cells):
    """worst roofline fraction / most collective-bound / paper-representative."""
    singles = [a for a in cells if a["mesh"] == "single"
               and a["kind"] == "train"]
    worst = min(singles, key=lambda a: a["roofline"]["roofline_fraction_kernel"])
    coll = max(cells, key=lambda a: (a["roofline"]["collective_s"]
                                     / max(a["roofline"]["compute_s"], 1e-9)))
    return worst, coll


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dir", default="experiments/dryrun")
    p.add_argument("--variant", default="baseline")
    p.add_argument("--what", default="roofline",
                   choices=["roofline", "dryrun", "pick"])
    p.add_argument("--mesh", default="single")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write the loaded cells as strict JSON")
    args = p.parse_args()
    cells = load(args.dir, args.variant)
    if args.json:
        # strict JSON: a NaN in any cell fails HERE, not in a consumer
        with open(args.json, "w") as fh:
            json.dump({"schema": "dryrun-cells/v1", "n": len(cells),
                       "cells": cells}, fh, indent=2, sort_keys=True,
                      allow_nan=False)
            fh.write("\n")
    if args.what == "roofline":
        print(fmt_table(cells, args.mesh))
    elif args.what == "dryrun":
        print(fmt_dryrun_summary(cells))
    else:
        worst, coll = pick_hillclimb(cells)
        print("worst fraction:", worst["arch"], worst["shape"],
              worst["roofline"]["roofline_fraction_kernel"])
        print("most collective-bound:", coll["arch"], coll["shape"],
              coll["mesh"],
              coll["roofline"]["collective_s"] / max(
                  coll["roofline"]["compute_s"], 1e-9))


if __name__ == "__main__":
    main()
