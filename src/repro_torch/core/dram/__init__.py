# Port of src/repro/core/dram/__init__.py.  ``spec`` and ``bank`` are copied;
# ``substrate``, ``villa``, ``controller`` and ``traces`` are in torch.
"""Faithful reproduction of the LISA DRAM substrate (HPCA'16 / 2018 summary).

Modules:
  spec        — the `DramSpec` device-model API: geometry + timing/energy
                presets (DDR3_1600 calibrated to Table 1, DDR4/LPDDR) and the
                `CopyMechanism` registry (DESIGN.md Sec. 6)
  bank        — bank-level contention under the virtual clock: refresher
                (tREFI/tRFC), per-bank row-state machines, and the request
                multiplexer (DESIGN.md Sec. 15)
  substrate   — data-correct functional DRAM bank with RBM / RISC / multicast
  villa       — the VILLA hot-row caching policy (Sec. 3.2.1, exact)
  controller  — command-level multi-core system simulator (Figs. 3/4
                orderings); mechanism config is data, and one loop runs a
                whole grid of configs x workloads as its lanes
  traces      — synthetic workload generation (SPEC traces are not shippable)
"""
from repro_torch.core.dram import (  # noqa: F401
    bank,
    controller,
    spec,
    substrate,
    traces,
    villa,
)
from repro_torch.core.dram.bank import (  # noqa: F401
    BankMachine,
    Refresher,
    RequestMultiplexer,
)
from repro_torch.core.dram.spec import DDR3_1600, DDR4_2400, DramSpec  # noqa: F401
