# Port of src/repro/faults/inject.py in torch: the fault-mode registry and
# the fault wrappers over the movement backends.
"""Fault modes + the fault-wrapping layer over the movement backends.

Two pieces, both registry-shaped:

1. **Fault-mode registry** — each mode is a transform
   ``fn(data, index, xor) -> data`` that returns a corrupted COPY of a
   payload tensor (its input is never written).  The ``(mode, index, xor)``
   fault operand is a host numpy array (:data:`NULL_FAULT` when no fault
   fires): the reference stages every mode under ``jnp.where`` so that one
   compilation serves every fault, while the port runs eagerly and applies
   a mode only when ``fault[0] != 0`` — a clean wave launches nothing extra
   and reads nothing back from the device.

2. **Backend wrappers** — :func:`install_fault_backends` interposes on the
   ``hop_chain`` and ``page_scatter`` legs through the registry's
   sanctioned :func:`~repro_torch.movement.registry.wrap_backend` API.  A
   wrapper consumes the env's ``fault`` operand exactly once (first wrapped
   leg in the plan) and applies it to the payload: in-flight corruption on
   the hop chain, landing corruption on the scatter.  The payload there is
   the page gather's fresh output buffer, so the source pool is never
   touched.  Plans that carry no ``fault`` key run the unwrapped backends'
   work unchanged.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.movement import registry as MR
from repro_torch.faults.spec import FAULT_CODES, NULL_FAULT  # noqa: F401

FaultMode = Callable[[torch.Tensor, int, int], torch.Tensor]

_FAULT_MODES: Dict[str, FaultMode] = {}


def register_fault(name: str) -> Callable[[FaultMode], FaultMode]:
    """Decorator: register one fault mode and assign its code.

    Same contract as the movement-backend registry: re-registering the SAME
    function (module reload) replaces silently; a different function under
    a taken name raises.  Codes are handed out in registration order, so
    they are deterministic per import order.
    """
    def deco(fn: FaultMode) -> FaultMode:
        old = _FAULT_MODES.get(name)
        if old is not None and (old.__module__, old.__qualname__) != (
                fn.__module__, fn.__qualname__):
            raise ValueError(f"fault mode {name!r} already registered by "
                             f"{old.__module__}.{old.__qualname__}")
        _FAULT_MODES[name] = fn
        FAULT_CODES.setdefault(name, len(FAULT_CODES))
        return fn
    return deco


def get_fault(name: str) -> FaultMode:
    try:
        return _FAULT_MODES[name]
    except KeyError:
        raise ValueError(f"unknown fault mode {name!r} "
                         f"(known: {sorted(_FAULT_MODES)})") from None


def fault_kinds() -> Tuple[str, ...]:
    return tuple(sorted(_FAULT_MODES))


def apply_fault(data: torch.Tensor, fault) -> torch.Tensor:
    """Apply the host ``(mode, index, xor)`` operand to ``data``: ``data``
    itself for the null fault (and for a code no mode holds, as the
    reference's ``jnp.where`` chain leaves it), else the registered mode's
    corrupted copy."""
    mode, index, xor = (int(v) for v in np.asarray(fault).reshape(3))
    if mode == 0:
        return data
    for name, fn in _FAULT_MODES.items():
        if FAULT_CODES[name] == mode:
            return fn(data, index, xor)
    return data


@register_fault("flip_byte")
def _flip_byte(data: torch.Tensor, index: int, xor: int) -> torch.Tensor:
    """XOR one element of the flat payload (xor != 0 => always detectable);
    ``xor`` is cast to the payload's dtype, the index clipped into it."""
    out = data.clone()
    flat = out.view(-1)
    t = min(max(index, 0), flat.numel() - 1)
    x = torch.tensor(xor, dtype=torch.int64).to(data.dtype).item()
    flat[t] ^= x
    return out


@register_fault("drop_page")
def _drop_page(data: torch.Tensor, index: int, xor: int) -> torch.Tensor:
    """Zero one leading-axis page of a pages-major payload (a lost RBM
    transfer).  Undetectable iff the page was already all-zero — which is
    why the chaos runs inject ``flip_byte``."""
    out = data.clone()
    out[min(max(index, 0), data.shape[0] - 1)] = 0
    return out


# ---------------------------------------------------------------------------
# the wrapping layer
# ---------------------------------------------------------------------------

# legs that carry payload bytes: corrupt post-hop (in flight) or pre-scatter
# (at landing).  The env's "fault" operand is consumed by the FIRST wrapped
# leg the plan executes, so a gather->hop->scatter chain applies it once.
WRAP_KINDS: Tuple[str, ...] = ("hop_chain", "page_scatter")
_PRE_KINDS = frozenset({"page_scatter"})


def _make_wrapper(kind: str, inner: MR.Backend) -> MR.Backend:
    def fault_wrapped(leg, env):
        fault = env.get("fault")
        if fault is None:
            return inner(leg, env)
        env = dict(env)
        del env["fault"]
        if kind in _PRE_KINDS:
            env["data"] = apply_fault(env["data"], fault)
            return inner(leg, env)
        env = dict(inner(leg, env))
        env["data"] = apply_fault(env["data"], fault)
        return env
    fault_wrapped.__qualname__ = f"fault_wrapped_{kind}"
    return fault_wrapped


def install_fault_backends() -> None:
    """Interpose the fault wrappers (idempotent) —
    :class:`repro_torch.serve.cluster.Cluster` installs them at
    construction when built with ``faults=``."""
    for kind in WRAP_KINDS:
        if kind not in MR.wrapped_kinds():
            MR.wrap_backend(kind, lambda inner, k=kind: _make_wrapper(k,
                                                                      inner))


def uninstall_fault_backends() -> None:
    """Restore the original backends (tests)."""
    for kind in WRAP_KINDS:
        MR.unwrap_backend(kind)
