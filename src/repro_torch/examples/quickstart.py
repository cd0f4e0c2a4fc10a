# Port of examples/quickstart.py: the same four steps through the port, on
# the card unless ``--device cpu``.  The tiered store's items are page
# blocks of 1 KiB pages, which the page kernels move.
"""Quickstart: the LISA substrate in five minutes.

1. The faithful DRAM reproduction: an 8 KB row copy via RBM hop chains,
   with Table-1-exact latency/energy.
2. 1-to-N multicast through intermediate row-buffer latching.
3. The device adaptation: the same policy object driving a tiered store.
4. A few training steps of a reduced assigned architecture.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core.dram import substrate as S
from repro_torch.core.dram.spec import DDR3_1600
from repro_torch.core.dram.villa import VillaConfig
from repro_torch.core.lisa import villa_cache as VC
from repro_torch.launch.train import main as train_main


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda, raising without a GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- 1. DRAM substrate: LISA-RISC copy --------------------------------
    # full 8 KB rows so every modeled cost is Table-1 exact (2 MB of cells)
    spec = DDR3_1600.with_geometry(16, 16)
    bank = S.make_bank(spec, generator=torch.Generator().manual_seed(0),
                       device=dev)
    bank2, lat, ene = S.lisa_risc_copy(bank, src_sa=1, src_row=3,
                                       dst_sa=8, dst_row=5, spec=spec)
    assert torch.equal(bank2.cells[8, 5], bank.cells[1, 3])
    print(f"LISA-RISC copy  (7 hops): {lat:.2f} ns, {ene:.4f} uJ "
          f"(paper Table 1: 196.5 ns / 0.12 uJ)")
    print(f"RowClone InterSA baseline: {spec.copy_latency('rc_intersa'):.2f} "
          f"ns / {spec.copy_energy('rc_intersa'):.2f} uJ -> "
          f"{spec.copy_latency('rc_intersa')/lat:.1f}x slower")

    # --- 2. 1-to-N multicast (paper Sec. 5.2) ------------------------------
    bank3, lat_b, _ = S.lisa_broadcast(bank, 1, 3, dst_sas=(4, 9, 14),
                                       dst_row=2, spec=spec)
    assert all(torch.equal(bank3.cells[d, 2], bank.cells[1, 3])
               for d in (4, 9, 14))
    print(f"1-to-3 multicast via intermediate latching: {lat_b:.2f} ns "
          f"(vs 3 separate copies: {3*lat:.2f} ns)")

    # --- 3. VILLA tiered store (device-side, same policy) -------------------
    cfg = VillaConfig(n_counters=32, n_hot=4, n_slots=4, epoch_len=8)
    slow = torch.randint(0, 256, (32, 1, 8, 128), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1)).to(dev)
    store = VC.make_store(slow, cfg)
    for i in [3, 9] * 16:                       # two hot items
        store, data, hit = VC.access(store, i, cfg)
    print(f"VILLA tiered store hit rate after warmup: "
          f"{float(VC.hit_rate(store)):.2f}")

    # --- 4. Train a reduced assigned architecture a few steps -------------
    res = train_main(["--arch", "tinyllama-1.1b", "--reduced", "--steps",
                      "10", "--batch", "4", "--seq", "64", "--log-every",
                      "5", "--device", dev.type])
    print(f"loss {res['first_loss']:.3f} -> {res['last_loss']:.3f} in 10 "
          f"steps")


if __name__ == "__main__":
    main()
