# Port of src/repro/analysis/dispatch.py in torch: the reference reads each
# entry point's jaxpr and compiled HLO; the port has neither, so it watches
# one call of each entry point instead.
"""The entry-point auditor: run each registered entry point once and
verify the contract it documents.

The reference proves its contracts statically, from the lowering, the
jaxpr and the compiled HLO.  The port has no compiler, so it watches one
call of each entry point (:class:`AuditTarget`), and each field of the
reference's :class:`EntryContract` maps onto what the call does:

* ``donate`` -> ``inplace``: the state the reference donates is written in
  place.  Every tensor of each named piece of state keeps its
  ``data_ptr()`` across the call (``audit-inplace``); on the card, the
  call also allocates no new buffer the size of that state
  (``audit-alloc``: the rise of ``torch.cuda.max_memory_allocated`` over
  the call stays below the state's bytes).  The bound means something
  where the state dwarfs a call's working buffers, as at serving
  geometry: a suspend widens its snapshot to int32 for the checksums (4x
  a snapshot) while a store holds tens of snapshots.
* ``uint8_preserving``: a ``TorchDispatchMode`` watches the call and fails
  it where an op that is not a view (``aten._to_copy``, ``aten.copy_``,
  any arithmetic) takes a ``uint8`` tensor and gives a floating one.  A
  view (``x.view(torch.float32)``, the bitcast the page paths use) is not
  a widening.
* ``no_host_transfer`` -> syncs a call.  On the card every synchronising
  call is counted through ``torch.cuda.set_sync_debug_mode("warn")``'s
  warnings (``.item()``, ``.cpu()``, ``nonzero``, boolean-mask indexing, a
  pageable copy, ``torch.cuda.synchronize``).  On the CPU the mode counts
  ``aten._local_scalar_dense``, which ``.item()``, ``int()``, ``float()``
  and ``bool()`` of a tensor reach; ``.cpu()``, ``.tolist()`` and
  ``.numpy()`` of a CPU tensor dispatch nothing and are seen on the card
  only.  The plain versions of the kernels (``kernels/ref.py``) range-check
  a host page table with ``bool()``; on the card a host table is checked
  on the host and a device table not at all, so those reads are not
  counted.
* ``dispatches_per_call`` -> ``launches``: the launches a call makes of
  each kernel, from ``kernels/ops.launch_counts()``.  The counters count
  the card's launches only, so this is checked on the card only.
* ``max_compiles`` is dropped: the port has no compiler and nothing to
  count.  The prefill bucket set still bounds the shapes a prefill takes
  (:func:`audit_bucket_stability`).

Findings use the :class:`~repro_torch.analysis.findings.Finding` shape of
the AST linter; their ``path`` is the pseudo-path ``entry:<name>``, so one
report covers both layers.
"""
from __future__ import annotations

import dataclasses
import sys
import warnings
from typing import (Any, Callable, Dict, FrozenSet, List, Mapping,
                    Optional, Sequence, Tuple)

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding
from repro_torch.kernels import ops

SCALAR_READ = torch.ops.aten._local_scalar_dense.default
# the warning torch.cuda.set_sync_debug_mode("warn") gives each sync (not
# the one that says the mode is a prototype)
SYNC_WARNING = "called a synchronizing CUDA operation"
# the plain versions of the kernels: their host-table checks are not syncs
_PLAIN_VERSIONS = ("repro_torch/kernels/ref.py", "repro_torch\\kernels\\ref.py")


@dataclasses.dataclass(frozen=True)
class EntryContract:
    """What one entry point promises (its docstring made checkable)."""
    inplace: FrozenSet[str] = frozenset()   # state written in place
    no_host_transfer: bool = True
    uint8_preserving: bool = False          # page path: no uint8->float
    # launches a call of each kernel of ``ops.KERNELS`` (one not named: 0)
    launches: Mapping[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class AuditTarget:
    """One registered entry point with example arguments at audit
    geometry.  ``state`` returns each piece of state the contract names
    (name -> a tensor or a tree of them: dicts, tuples, named tuples); it
    is read just before and just after the call."""
    name: str
    fn: Callable
    args: tuple
    contract: EntryContract
    kwargs: Dict[str, object] = dataclasses.field(default_factory=dict)
    state: Optional[Callable[[], Dict[str, Any]]] = None


def _entry_finding(rule: str, target_name: str, msg: str) -> Finding:
    return Finding(rule=rule, path=f"entry:{target_name}", line=0,
                   message=msg)


def tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and (named) tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in tree for t in tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors(x)]
    return []


def _in_plain_version() -> bool:
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_filename.endswith(_PLAIN_VERSIONS):
            return True
        f = f.f_back
    return False


class CallWatch(TorchDispatchMode):
    """Watches every op of a call: the scalar reads (``.item()``,
    ``int()``, ``float()``, ``bool()`` of a tensor) outside the kernels'
    plain versions, and each op that widens ``uint8`` to a float."""

    def __init__(self):
        super().__init__()
        self.scalar_reads = 0
        self.upcasts: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is SCALAR_READ:
            if not _in_plain_version():
                self.scalar_reads += 1
        elif not func.is_view:
            ins = [t for t in tensors(list(args) + list((kwargs or {})
                                                       .values()))]
            if any(t.dtype == torch.uint8 for t in ins):
                for t in tensors(out):
                    if t.is_floating_point():
                        self.upcasts.append(f"{func}: uint8->"
                                            f"{str(t.dtype).split('.')[-1]}")
                        break
        return out


def _ptrs(state: Dict[str, Any]) -> Dict[str, List[int]]:
    return {k: [t.data_ptr() for t in tensors(v)] for k, v in state.items()}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(tree))


def audit_target(target: AuditTarget,
                 device: Optional[torch.device] = None
                 ) -> Tuple[Dict, List[Finding]]:
    """Audit ONE entry point against its contract by one watched call;
    returns the record for the report plus any findings.  On the card
    (``device`` of type cuda) a first call runs unwatched, so first-use
    loads and the caching allocators' first blocks are not counted."""
    c = target.contract
    on_card = device is not None and torch.device(device).type == "cuda"
    findings: List[Finding] = []
    record: Dict[str, object] = {"name": target.name}

    def call():
        return target.fn(*target.args, **target.kwargs)

    if on_card:
        call()
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        before_launches = ops.launch_counts()
    state = target.state() if target.state is not None else {}
    missing = sorted(set(c.inplace) - set(state))
    if missing:
        raise ValueError(f"{target.name}: the contract names state "
                         f"{missing} that the target does not give")
    inplace = {k: state[k] for k in sorted(c.inplace)}
    before = _ptrs(inplace)
    watch = CallWatch()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if on_card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with watch:
                call()
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode(0)
    after_state = target.state() if target.state is not None else {}
    after = _ptrs({k: after_state[k] for k in inplace})

    if on_card:
        syncs = sum(str(w.message).startswith(SYNC_WARNING)
                    for w in caught)
        torch.cuda.synchronize(device)
        grown = torch.cuda.max_memory_allocated(device) - base
        after_launches = ops.launch_counts()
        launches = {k: after_launches[k] - before_launches[k]
                    for k in ops.KERNELS}
        record["launches"] = launches
        record["alloc_bytes"] = int(grown)
        want = {k: int(c.launches.get(k, 0)) for k in ops.KERNELS}
        if launches != want:
            findings.append(_entry_finding(
                "audit-launches", target.name,
                f"launches a call {launches}, the contract says {want}"))
        limit = _nbytes(inplace)
        if inplace and grown >= limit:
            findings.append(_entry_finding(
                "audit-alloc", target.name,
                f"the call allocated {grown} B, at least the {limit} B of "
                f"the state it writes in place ({sorted(inplace)}): a copy "
                f"of it"))
    else:
        syncs = watch.scalar_reads
    record["syncs"] = int(syncs)
    if c.no_host_transfer and syncs:
        findings.append(_entry_finding(
            "audit-host-transfer", target.name,
            f"{syncs} device->host sync(s) in one call; the contract "
            f"allows none"))

    record["inplace"] = sorted(inplace)
    record["inplace_tensors"] = sum(len(v) for v in before.values())
    moved = sorted(k for k in inplace if before[k] != after[k])
    if moved:
        findings.append(_entry_finding(
            "audit-inplace", target.name,
            f"state {moved} is documented as written in place but the "
            f"call replaced its tensors (a copy where the reference "
            f"donates)"))

    if c.uint8_preserving:
        record["uint8_upcasts"] = len(watch.upcasts)
        if watch.upcasts:
            findings.append(_entry_finding(
                "audit-dtype", target.name,
                f"uint8 page path widens to float: "
                f"{sorted(set(watch.upcasts))} — snapshots must stay "
                f"bit-exact uint8"))
    return record, findings


def audit_bucket_stability(engine, declared: Sequence[int]) -> List[Finding]:
    """The prefill shape set: the image of ``_bucket_len`` over every
    admissible prompt length must be exactly the declared bucket set
    (``entrypoints.prefill_buckets``, the Engine's documented powers of
    two) — otherwise a prompt length prefills at a shape no target
    audits."""
    image = sorted({engine._bucket_len(n)
                    for n in range(1, engine.max_len + 1)})
    if image != sorted(declared):
        return [_entry_finding(
            "audit-prefill-buckets", "prefill",
            f"bucket image {image} over lengths 1..{engine.max_len} "
            f"!= declared bucket set {sorted(declared)}")]
    return []


def run_audit(targets: Sequence[AuditTarget], *,
              device: Optional[torch.device] = None,
              extra_findings: Sequence[Finding] = ()) -> Dict[str, object]:
    """Audit every target; returns the report's ``audit`` section (findings
    inline, serialized)."""
    records, findings = [], list(extra_findings)
    for t in targets:
        rec, fs = audit_target(t, device)
        records.append(rec)
        findings.extend(fs)
    return {
        "targets": records,
        "device": "cpu" if device is None else torch.device(device).type,
        "findings": [f.as_dict() for f in findings],
    }
