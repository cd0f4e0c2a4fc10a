# Port of src/repro/fork/__init__.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""Zero-copy session forking: refcounted CoW page aliasing (RowClone).

See :mod:`repro_torch.fork.table` for the ledger and DESIGN.md Sec. 13 for the
paper mapping (alias = RowClone FPM, materialize = PSM via LISA hops,
CoW trigger = first post-fork activate).
"""
from repro_torch.fork.table import ForkPageTable

__all__ = ["ForkPageTable"]
