# Port of src/repro/core/dram/__init__.py.  ``spec`` and ``bank`` are copied,
# ``villa`` is in torch; the substrate, controller and traces modules belong
# to a later slice.
"""The DRAM device model: ``spec`` (DramSpec, presets, CopyMechanism
registry), ``bank`` (bank-level contention under the virtual clock:
refresher, per-bank row-state machines, request multiplexer) and ``villa``
(the VILLA hot-row caching policy)."""
from repro_torch.core.dram.bank import (  # noqa: F401
    BankMachine,
    Refresher,
    RequestMultiplexer,
)
from repro_torch.core.dram.spec import DDR3_1600, DDR4_2400, DramSpec  # noqa: F401
