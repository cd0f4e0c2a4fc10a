# Port of examples/lisa_dram_demo.py: the same report through the port's
# DRAM modules, on the card unless ``--device cpu``.
"""Full reproduction demo: Table 1 + Figs. 3/4 orderings on synthetic
multiprogrammed workloads (the paper's system evaluation, Sec. 3), under the
`DramSpec` device-model API.

Run:  PYTHONPATH=src python -m repro_torch.examples.lisa_dram_demo [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core.dram.controller import (MechanismConfig, simulate_grid,
                                              stack_traces, weighted_speedup)
from repro_torch.core.dram.spec import DDR3_1600, DDR4_2400
from repro_torch.core.dram.traces import TraceConfig, generate

# (label, config, the paper's number) of the system evaluation; the
# memcpy baseline comes first
CONFIGS = (
    ("memcpy", MechanismConfig("memcpy"), ""),
    ("RowClone-InterSA", MechanismConfig("rc_intersa"), ""),
    ("LISA-RISC", MechanismConfig("lisa"), "paper: +59.6%"),
    ("LISA-(RISC+VILLA)", MechanismConfig("lisa", use_villa=True),
     "paper: +16.5% over RISC"),
    ("LISA-ALL", MechanismConfig("lisa", use_villa=True, use_lip=True),
     "paper: +94.8% total, +8.8% from LIP"),
    ("RC-InterSA+VILLA", MechanismConfig("memcpy", use_villa=True,
                                         villa_copy_mech="rc_intersa"),
     "paper: -52.3% (slow copies kill caching)"),
)
N_REQUESTS = 16384
SEED = 1


def system_eval(device, n_requests: int = N_REQUESTS, seed: int = SEED):
    """The demo's trace (drawn from a CPU generator seeded ``seed``) under
    every config of :data:`CONFIGS`, one lane each: ``(trace config, the
    grid's results with a (config, 1) lead)``."""
    tcfg = TraceConfig(n_requests=n_requests)
    tr = generate(torch.Generator().manual_seed(seed), tcfg, DDR3_1600,
                  device=device)
    return tcfg, simulate_grid(stack_traces([tr]), tcfg,
                               [m for _, m, _ in CONFIGS], DDR3_1600)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda, raising without a GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    spec = DDR3_1600
    print(f"=== Table 1 (8 KB copy, preset {spec.name}) ===")
    print(f"{'mechanism':14s} {'latency ns':>10s} {'energy uJ':>10s}")
    for mech, (lat, ene) in spec.table1().items():
        print(f"{mech:14s} {lat:10.2f} {ene:10.4f}")
    print(f"\nRBM bandwidth: {spec.rbm_bw_gbps:.0f} GB/s = "
          f"{spec.rbm_bw_gbps/spec.channel_bw_gbps:.1f}x a DDR4-2400 channel "
          f"(paper: 26x)")
    print(f"LIP precharge: {spec.precharge_latency(False):.0f} ns -> "
          f"{spec.precharge_latency(True):.0f} ns (paper: 2.6x)")

    print(f"\n=== System evaluation (4-core synthetic workloads, "
          f"{device.type}) ===")
    _, grid = system_eval(device)
    base_stall, base_e = grid["core_stall"][0, 0], grid["energy_uJ"][0, 0]
    for i, (name, _, paper) in enumerate(CONFIGS[1:], start=1):
        ws = float(weighted_speedup(base_stall, grid["core_stall"][i, 0]))
        ene = 1 - float(grid["energy_uJ"][i, 0]) / float(base_e)
        hit = float(grid["villa_hit_rate"][i, 0])
        print(f"{name:18s} WS {ws:6.3f}x  energy {ene:+.1%}  hit {hit:.2f}  "
              f"{paper}")

    print("\n=== Preset sweep: LISA-RISC-7 latency across devices ===")
    for s in (DDR3_1600, DDR4_2400):
        print(f"{s.name:12s} {s.copy_latency('lisa', 7):8.2f} ns "
              f"(RC-InterSA {s.copy_latency('rc_intersa'):8.2f} ns)")


if __name__ == "__main__":
    main()
