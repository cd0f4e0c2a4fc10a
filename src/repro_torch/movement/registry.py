# Port of src/repro/movement/registry.py: a copy of the reference module, with
# the lazy ``jax.core`` import dropped (PyTorch runs eagerly: every execute is
# on the host, so there is no trace to keep marks out of).
"""Backend registry + executor for :class:`~repro_torch.movement.plan.MovementPlan`.

This extends PR 1's ``CopyMechanism`` registry pattern (objects in a
registry, not string if/elif chains) from the DRAM *model* up to the real
array layer: each leg kind names a backend callable that performs the
movement on real arrays.  Default backends (:mod:`repro_torch.movement.backends`)
cover pack/unpack staging, Pallas page gather/scatter, VMEM tile copies,
mesh hop chains and host staging; :mod:`repro_torch.core.lisa.villa_cache`
registers the VILLA policy-mediated tier legs on import.

A backend has signature ``fn(leg, env) -> env``: ``env`` is a dict of named
operands (traced arrays are fine — execute composes under an enclosing
``jax.jit``), and each leg reads the keys it needs and returns an updated
env.  Conventional keys:

  ``data``      the payload moving through the legs
  ``cache``     a batched pytree (pack/unpack source/target), ``slot(s)``
  ``store``     a TieredStore (tier legs), ``item(s)`` its indices
  ``pool``      a page pool array, ``table`` its page table
  ``shardings`` optional placement for host->device staging
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

from repro_torch.movement.plan import Leg, MovementPlan

Env = Dict[str, Any]
Backend = Callable[[Leg, Env], Env]

_BACKENDS: Dict[str, Backend] = {}


def register_backend(kind: str) -> Callable[[Backend], Backend]:
    """Decorator: register the movement backend for one leg kind.

    Re-registering the SAME backend (same module/qualname — a module
    reload) replaces it silently, so registering modules stay
    reload-safe; a different function under a taken kind still raises.
    Reload-safety holds under interposition too: while ``kind`` is
    wrapped, ownership is judged against the stored ORIGINAL, and a
    reload refreshes that original in place — the wrapper stays
    installed and the next :func:`unwrap_backend` restores the fresh fn.
    """
    def deco(fn: Backend) -> Backend:
        old = _WRAPPED.get(kind, _BACKENDS.get(kind))
        if old is not None and (old.__module__, old.__qualname__) != (
                fn.__module__, fn.__qualname__):
            raise ValueError(f"movement backend {kind!r} already registered "
                             f"by {old.__module__}.{old.__qualname__}")
        if kind in _WRAPPED:
            _WRAPPED[kind] = fn
        else:
            _BACKENDS[kind] = fn
        return fn
    return deco


def get_backend(kind: str) -> Backend:
    try:
        return _BACKENDS[kind]
    except KeyError:
        raise ValueError(
            f"unknown movement backend {kind!r} (known: "
            f"{sorted(_BACKENDS)}); import the module that registers it "
            f"(tier legs live in repro_torch.core.lisa.villa_cache)") from None


def backend_kinds() -> Tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


# Sanctioned interposition: a wrapper layer (fault injection, tracing) may
# wrap a registered backend without violating the one-owner contract above.
# Originals are kept so the wrap is reversible and never stacks silently.
_WRAPPED: Dict[str, Backend] = {}


def wrap_backend(kind: str,
                 make: Callable[[Backend], Backend]) -> Backend:
    """Replace backend ``kind`` with ``make(original)``; returns the wrapper.

    Raises if ``kind`` is unknown or already wrapped (wrappers must not
    stack — unwrap first).  The original is restored by
    :func:`unwrap_backend`.
    """
    if kind in _WRAPPED:
        raise ValueError(f"movement backend {kind!r} is already wrapped; "
                         f"unwrap_backend({kind!r}) first")
    original = get_backend(kind)
    wrapper = make(original)
    _WRAPPED[kind] = original
    _BACKENDS[kind] = wrapper
    return wrapper


def unwrap_backend(kind: str) -> None:
    """Restore the original backend for ``kind`` (no-op if not wrapped)."""
    original = _WRAPPED.pop(kind, None)
    if original is not None:
        _BACKENDS[kind] = original


def wrapped_kinds() -> Tuple[str, ...]:
    return tuple(sorted(_WRAPPED))


# Optional execution tracing (repro_torch.obs): when a tracer is installed,
# host-side executes mark each leg as an instant on the tracer's current
# lane cursor (cat="exec").  Pricing spans stay the scheduler's job — exec
# marks record WHICH backends actually ran, so plan-vs-execution drift is
# visible in the same timeline.
_TRACER: Any = None


def set_tracer(tracer: Any) -> None:
    """Install (or with ``None`` remove) the execution tracer."""
    global _TRACER
    _TRACER = tracer


def execute(plan: MovementPlan, env: Env | None = None, **operands) -> Env:
    """Run every leg of ``plan`` through its registered backend.

    Eager: each backend launches its device work on the current stream.
    Returns the final env; callers read their result keys (``data``,
    ``cache``, ``store``, ``pool``, ...) from it.
    """
    env = dict(env or {})
    env.update(operands)
    tr = _TRACER
    mark = tr is not None and getattr(tr, "enabled", False)
    for leg in plan.legs:
        if mark:
            tr.instant(leg.kind, cat="exec",
                       attrs={"nbytes": leg.nbytes, "batch": leg.batch,
                              "hops": leg.hops})
        env = get_backend(leg.kind)(leg, env)
    return env
