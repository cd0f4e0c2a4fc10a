# Port of src/repro/movement/__init__.py.
"""One movement substrate: plan -> execute for every bulk transfer.

Public surface::

    from repro_torch import movement as MV

    layout = MV.Layout.pages(MV.PageSpec.for_cache(cache))
    p = MV.plan(MV.Transfer(MV.Tier("compute"), MV.Tier("slow"),
                            layout, policy=villa_cfg), spec)
    store = MV.execute(p, cache=cache, slot=slot,
                       store=store, item=idx)["store"]
    p.cost.ns_lisa, p.cost.ns_memcpy      # Table-1 pricing, system scale
"""
from repro_torch.movement.paging import (
    PageSpec,
    cache_leaves,
    pack_slot,
    page_checksums,
    row_page_table,
    unpack_into_slot,
    verify_pages,
)
from repro_torch.movement.plan import (
    HopChainLeg,
    HostStageLeg,
    Layout,
    Leg,
    MovementCost,
    MovementPlan,
    PackLeg,
    PageAliasLeg,
    PageGatherLeg,
    PageScatterLeg,
    TierReadLeg,
    TierWriteLeg,
    TileCopyLeg,
    Tier,
    Transfer,
    UnpackLeg,
    ContendedCost,
    contend,
    fuse,
    leg_costs,
    plan,
    retry_cost,
    ring_plan,
)
from repro_torch.movement.registry import (
    Env,
    backend_kinds,
    execute,
    get_backend,
    register_backend,
    set_tracer,
    unwrap_backend,
    wrap_backend,
    wrapped_kinds,
)
from repro_torch.movement import backends as _backends  # noqa: F401  (registers)

__all__ = [
    "PageSpec", "cache_leaves", "pack_slot", "unpack_into_slot",
    "page_checksums", "verify_pages", "row_page_table",
    "Tier", "Layout", "Transfer", "Leg", "MovementCost", "MovementPlan",
    "PackLeg", "UnpackLeg", "PageAliasLeg", "PageGatherLeg",
    "PageScatterLeg",
    "TierReadLeg", "TierWriteLeg", "TileCopyLeg", "HopChainLeg",
    "HostStageLeg", "plan", "ring_plan", "fuse", "retry_cost", "leg_costs",
    "ContendedCost", "contend",
    "Env", "register_backend", "get_backend", "backend_kinds", "execute",
    "wrap_backend", "unwrap_backend", "wrapped_kinds", "set_tracer",
]
