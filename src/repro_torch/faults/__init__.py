# Port of src/repro/faults/__init__.py: the reference's exports, from the
# port's faults modules.
"""Deterministic chaos: seeded fault injection, detection and recovery.

The subsystem threads the whole serving stack:

  * :mod:`repro_torch.faults.spec`    — :class:`FaultSpec` /
    :class:`FaultInjector` (counter-based seeded RNG, never wall-clock)
    and the host-side corruption ledger.
  * :mod:`repro_torch.faults.inject`  — the fault-mode registry (flip_byte /
    drop_page) and the wrapping layer over the movement backend registry
    (hop_chain / page_scatter legs).
  * :mod:`repro_torch.faults.recover` — session snapshots over priced
    movement plans and snapshot-backed restore (replica death, corrupt-at-
    rest repair), plus disk persistence via the checkpoint manager.

Detection itself lives in the substrate: every ``pack_pages`` leg emits a
per-page checksum sidecar and every ``unpack_pages`` leg verifies it
(:mod:`repro_torch.movement.paging`), so the chaos layer only decides WHAT
breaks — the movement layer proves WHETHER it was caught.
"""
from repro_torch.faults.inject import (
    NULL_FAULT,
    apply_fault,
    fault_kinds,
    get_fault,
    install_fault_backends,
    register_fault,
    uninstall_fault_backends,
)
from repro_torch.faults.recover import (
    SessionSnapshot,
    load_snapshots,
    repair_row,
    restore_session,
    save_snapshots,
    snapshot_sessions,
)
from repro_torch.faults.spec import FAULT_CODES, FaultInjector, FaultSpec

__all__ = [
    "FaultSpec", "FaultInjector", "FAULT_CODES", "NULL_FAULT",
    "register_fault", "get_fault", "fault_kinds", "apply_fault",
    "install_fault_backends", "uninstall_fault_backends",
    "SessionSnapshot", "snapshot_sessions", "restore_session",
    "repair_row",
    "save_snapshots", "load_snapshots",
]
