# Port of src/repro/checkpoint/manager.py in torch.  The on-disk format is
# the reference's (step_<N>/arrays.npz + meta.json + the crc trailer, leaf
# keys by tree path), so either package verifies and restores what the
# other wrote.  ``restore`` takes a ``device`` for one device besides the
# reference's ``shardings``, and ``save`` a tree laid out on a mesh takes
# its ``shardings`` (a port's laid-out leaf does not know its layout).
"""Fault-tolerant checkpointing: atomic save / restore / auto-resume.

Layout: <dir>/step_<N>/arrays.npz + meta.json + trailer.json, written to a
tmp dir and renamed (atomic on POSIX) so a crash mid-save never corrupts the
latest checkpoint.  Leaves are keyed by tree path (``a/b/0``: dict keys in
sorted order, sequence indices, named-tuple field names), so restore works
against any structurally-equal target.

Device<->host staging is a planned movement: both directions lower through
``movement.plan`` to a host-staging leg — the off-chip channel, the
"memcpy" path the in-fabric legs are priced against — so checkpoint traffic
is byte-accounted by the same substrate as every other bulk transfer
(``last_move_cost()`` exposes the most recent plan's cost).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import types
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import movement as MV
from repro_torch import resolve_device

_LAST_COST: Optional[MV.MovementCost] = None


class CorruptCheckpoint(RuntimeError):
    """A checkpoint failed integrity verification: torn write, truncation,
    or on-disk bit rot.  Raised by :func:`verify_checkpoint` (and hence
    :func:`restore`) instead of silently restoring garbage state."""


def last_move_cost() -> Optional[MV.MovementCost]:
    """MovementCost of the most recent save/restore staging (None before
    any staging ran): checkpoint bytes over the modeled channel."""
    return _LAST_COST


def _sized(leaf):
    """What ``Layout.tree`` sizes a leaf by: a tensor as its shape and an
    element of its width (numpy has no name for every torch dtype), any
    other leaf as itself."""
    if isinstance(leaf, torch.Tensor):
        return types.SimpleNamespace(
            shape=tuple(leaf.shape),
            dtype=np.dtype((np.void, leaf.element_size())))
    return leaf


def stage(leaves, to_host: bool, device=None) -> Tuple[list, MV.MovementPlan]:
    """Move a list of leaves across the channel through one host-staging
    plan; returns the moved leaves and the plan (its ``cost`` is the
    transfer's price)."""
    src, dst = (("device", "host") if to_host else ("host", "device"))
    p = MV.plan(MV.Transfer(MV.Tier(src), MV.Tier(dst),
                            MV.Layout.tree([_sized(l) for l in leaves])))
    return MV.execute(p, data=leaves, device=device)["data"], p


def _stage(leaves, to_host: bool, device=None):
    global _LAST_COST
    out, p = stage(leaves, to_host, device)
    _LAST_COST = p.cost
    return out


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in the reference's flattening order: dict
    keys sorted, sequences and named tuples in order; None is an empty
    subtree, as in ``jax.tree_util``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    out = []
    for k, v in items:
        out.extend(_flatten(v, prefix + (k,)))
    return out


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves`` (None subtrees stay None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        got = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: got[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*[_unflatten(getattr(tree, f), leaves)
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _file_crc(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def save(tree: Any, ckpt_dir: str, step: int, keep_last: int = 3,
         shardings: Any = None) -> str:
    """Write ``tree`` as ``step``'s checkpoint.  A tree laid out on a mesh
    (``train.shardings``) comes with its matching tree of
    ``NamedSharding``s: its full arrays are gathered over the mesh's rings
    and written in the same format; on ranks every rank gathers, rank 0
    writes and the others wait for it at a barrier."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if shardings is not None:
        from repro_torch.train import shardings as SH
        mesh = _mesh_of(shardings)
        tree = SH.unshard(tree, shardings)
        if not mesh.stacked:
            import torch.distributed as dist
            if dist.get_rank() != 0:
                dist.barrier()
                return final
            try:
                return save(tree, ckpt_dir, step, keep_last)
            finally:
                dist.barrier()
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    staged = _stage([l for _, l in flat], to_host=True)
    arrays = {p: a for (p, _), a in zip(flat, staged)}
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        npz = os.path.join(tmp, "arrays.npz")
        np.savez(npz, **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "n_arrays": len(arrays)}, f,
                      allow_nan=False)
        # Integrity trailer: crc + size of the payload, written last inside
        # the tmp dir so the atomic rename publishes data and trailer
        # together — a torn copy of this directory is always detectable.
        with open(os.path.join(tmp, "trailer.json"), "w") as f:
            json.dump({"crc32": _file_crc(npz),
                       "size": os.path.getsize(npz)}, f, allow_nan=False)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, d, "meta.json")):
            out.append(int(d[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def verify_checkpoint(ckpt_dir: str, step: int) -> None:
    """Check a checkpoint's integrity trailer; raise
    :class:`CorruptCheckpoint` on any mismatch.

    Catches the failure modes the atomic rename alone cannot: a partial
    copy of the directory (a copy interrupted mid-``arrays.npz``), a
    truncated payload, or flipped bits at rest.  A missing trailer is
    itself treated as corruption ("fail closed")."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    npz = os.path.join(d, "arrays.npz")
    trailer_path = os.path.join(d, "trailer.json")
    if not os.path.exists(npz):
        raise CorruptCheckpoint(f"{d}: missing arrays.npz")
    if not os.path.exists(trailer_path):
        raise CorruptCheckpoint(f"{d}: missing integrity trailer")
    try:
        with open(trailer_path) as f:
            trailer = json.load(f)
        crc, size = int(trailer["crc32"]), int(trailer["size"])
    except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
        raise CorruptCheckpoint(f"{d}: unreadable trailer ({e})") from e
    actual_size = os.path.getsize(npz)
    if actual_size != size:
        raise CorruptCheckpoint(
            f"{d}: arrays.npz truncated or padded "
            f"({actual_size} bytes, trailer says {size})")
    actual_crc = _file_crc(npz)
    if actual_crc != crc:
        raise CorruptCheckpoint(
            f"{d}: arrays.npz checksum mismatch "
            f"(crc32 {actual_crc:#010x}, trailer says {crc:#010x})")


def _mesh_of(shardings):
    return next(sh for _, sh in _flatten(shardings)).mesh


def restore(tree_like: Any, ckpt_dir: str, step: Optional[int] = None,
            device=None, shardings: Any = None) -> Any:
    """Restore into the structure of ``tree_like`` (a nested dict / list /
    tuple / named tuple whose leaves name the arrays to read); every leaf
    comes back as a tensor in the dtype it was saved with, on ``device``
    (default: cuda, raising without a GPU).

    ``shardings``: a matching tree of ``NamedSharding``s over one mesh —
    each leaf comes back laid out on it (its local devices' slices on dim
    0, on the mesh's device), whatever mesh wrote it: the elastic rescale.

    Integrity-verified first: a torn, truncated, or bit-rotted checkpoint
    raises :class:`CorruptCheckpoint` rather than restoring garbage.
    """
    if shardings is not None and device is not None:
        raise ValueError("restore takes a device or shardings (whose mesh "
                         "names the device), not both")
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    verify_checkpoint(ckpt_dir, step)
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    data = np.load(path)
    flat = _flatten(tree_like)
    if shardings is None:
        device = resolve_device(device)
        hosted = [data[p] for p, _ in flat]
    else:
        shard_flat = [sh for _, sh in _flatten(shardings)]
        if len(shard_flat) != len(flat):
            raise ValueError(f"{len(shard_flat)} shardings for {len(flat)} "
                             f"leaves")
        device = shard_flat[0].mesh.device
        hosted = []
        for (p, _), sh in zip(flat, shard_flat):
            a = data[p]
            hosted.append(np.stack([a[s] for s in sh.slices(a.shape)]))
    leaves = _stage(hosted, to_host=False, device=device)
    return _unflatten(tree_like, iter(leaves))
