# Port of src/repro/faults/recover.py in torch.  Snapshots are host numpy
# arrays of the reference's dtypes (uint8 pages, uint32 sums), so the npz
# files the two packages write are the same.
"""Session snapshots and snapshot-backed recovery for the replica fleet.

The recovery source for replica death is a periodic *session snapshot*: the
suspended pages PLUS their checksum sidecar rows, staged device→host
through the same priced host-staging movement plan the checkpoint manager
uses — snapshot traffic is byte-accounted like every other transfer.
Restore is the reverse plan: host→device staging, an ``adopt_session``
registration, a slow-pool row write and a fast-tag invalidation (the fast
tier may hold the pre-failure — possibly corrupt — bytes).

Snapshots can also persist to disk in the checkpoint manager's atomic
``step_<N>`` format (:func:`save_snapshots` / :func:`load_snapshots`),
protected by the manager's crash-consistency trailer — a torn snapshot
directory is rejected, never restored as garbage state.

The engine keeps its checksums as int64 tensors holding uint32 values; a
snapshot stages them as int32 (the same 4 bytes a page, so the plan prices
what the reference's uint32 sidecar moves) and holds them as uint32.
"""
from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import movement as MV
from repro_torch.checkpoint import manager as CM


class SessionSnapshot(NamedTuple):
    """One suspended session, host-resident: enough to re-admit it
    anywhere (pages are dtype-preserving uint8; ``sums`` is the checksum
    sidecar row computed at suspend time, so a restored session is
    verify-clean by construction).

    A FORKED family snapshots its shared physical row ONCE: the
    lowest-uid alias carries the pages, every other alias is a meta-only
    entry with ``alias_of`` naming the carrier and ``pages``/``sums``
    None.  Restore re-attaches aliases to the carrier's restored row by
    bookkeeping alone — one staged copy, one repair, the whole family
    healed."""
    uid: int
    pos: int
    tok: int
    pages: Optional[np.ndarray]       # (n_pages, P, d) uint8; None for alias
    sums: Optional[np.ndarray]        # (n_pages,) uint32; None for alias
    alias_of: Optional[int] = None    # carrier uid when this is an alias


def _zero_cost() -> MV.MovementCost:
    return MV.MovementCost(0, 0, 0.0, 0.0, 0.0, 0.0)


def _add(a: MV.MovementCost, b: MV.MovementCost) -> MV.MovementCost:
    return MV.MovementCost(a.bytes + b.bytes, max(a.hops, b.hops),
                           a.ns_lisa + b.ns_lisa,
                           a.ns_memcpy + b.ns_memcpy,
                           a.uj_lisa + b.uj_lisa,
                           a.uj_memcpy + b.uj_memcpy)


def snapshot_sessions(cluster) -> Tuple[Dict[int, "SessionSnapshot"],
                                        MV.MovementCost]:
    """Snapshot every suspended session in the fleet to host memory.

    One host-staging movement plan per replica with live sessions (the
    pages and sidecar rows of all its sessions travel as one batched
    transfer over the modeled channel).  Returns ``(snaps, total_cost)``;
    the scheduler records the cost as a ``snapshot_wave`` decision —
    write-behind traffic that overlaps decode, so it is priced but not
    charged to the critical-path clock.
    """
    snaps: Dict[int, SessionSnapshot] = {}
    total = _zero_cost()
    for eng in cluster.replicas:
        # ACTIVE sessions keep a stale session_pos entry; their store row is
        # a leftover the next suspend overwrites — snapshotting it would
        # capture out-of-date (possibly sidecar-inconsistent) bytes, so only
        # truly suspended sessions are snapshot candidates.
        active = {req.uid for req in eng.active.values()}
        uids = sorted(u for u in eng.session_pos if u not in active)
        if not uids:
            continue
        # fork-aware: stage each PHYSICAL row once.  The lowest-uid alias
        # of a shared row is its carrier; the rest become meta-only alias
        # entries — a 64-way fork family costs ONE row of snapshot traffic,
        # not 64.
        phys_of = {u: (eng.forks.resolve(u) if u in eng.forks
                       else u % eng.n_sessions) for u in uids}
        carrier_of: Dict[int, int] = {}
        for u in uids:                       # sorted: lowest uid carries
            carrier_of.setdefault(phys_of[u], u)
        carriers = sorted(carrier_of.values())
        idxs = eng._dev([phys_of[u] for u in carriers], torch.long)
        # int64 -> int32 keeps the low 32 bits: the uint32 values' bytes
        leaves = [eng.sessions.slow.index_select(0, idxs),
                  eng.session_sums.index_select(0, idxs).to(torch.int32)]
        (pages, sums), p = CM.stage(leaves, to_host=True)
        sums = sums.view(np.uint32)
        total = _add(total, p.cost)
        for j, uid in enumerate(carriers):
            snaps[uid] = SessionSnapshot(uid, eng.session_pos[uid],
                                         eng.session_tok[uid],
                                         pages[j], sums[j])
        for uid in uids:
            if uid in snaps:
                continue
            snaps[uid] = SessionSnapshot(
                uid, eng.session_pos[uid], eng.session_tok[uid],
                None, None, alias_of=carrier_of[phys_of[uid]])
    return snaps, total


def _write_row(cluster, eng, snap: SessionSnapshot,
               idx: int) -> MV.MovementCost:
    """Stage ``snap``'s pages and sums host→device into store row ``idx``
    of ``eng`` (pool and sidecar), dropping the row's fast-tier residency;
    returns the staging cost."""
    leaves = [np.asarray(snap.pages),
              np.asarray(snap.sums, np.uint32).view(np.int32)]
    (pages_dev, sums_dev), p = CM.stage(leaves, to_host=False,
                                        device=eng.device)
    eng.sessions.slow[idx] = pages_dev
    eng.session_sums[idx] = sums_dev.to(torch.int64) & 0xFFFFFFFF
    cluster._invalidate_fast(eng, [idx])
    return p.cost


def restore_session(cluster, snap: SessionSnapshot,
                    replica: int) -> Optional[MV.MovementCost]:
    """Re-admit one snapshot onto ``replica`` via the priced channel.

    Stages pages + sidecar host→device, registers the session
    (``adopt_session`` — collisions evict explicitly, like any suspend),
    overwrites the slow-pool row, and invalidates any stale fast-tier
    residency so the next resume reads the restored bytes.  Returns the
    staging cost (the scheduler charges it to the virtual clock as a
    ``recover_wave`` — recovery IS on the critical path).

    An ALIAS snapshot (``alias_of`` set) restores for free: its carrier
    already staged the shared row, so the alias re-attaches to the
    carrier's restored row by fork-table bookkeeping alone.  The carrier
    must be restored on ``replica`` FIRST (the scheduler orders owners
    before aliases); returns None if it is not — the caller writes the
    alias off as lost."""
    eng = cluster.replicas[replica]
    if snap.alias_of is not None:
        if (snap.alias_of not in eng.session_pos
                or snap.alias_of not in eng.forks):
            return None
        home = cluster.residence.get(snap.uid)
        if (home is not None
                and snap.uid in cluster.replicas[home].session_pos):
            cluster.replicas[home].drop_session(snap.uid)
        eng.adopt_alias(snap.uid, snap.pos, snap.tok, snap.alias_of)
        cluster.residence[snap.uid] = replica
        return _zero_cost()
    home = cluster.residence.get(snap.uid)
    if home is not None and snap.uid in cluster.replicas[home].session_pos:
        cluster.replicas[home].drop_session(snap.uid)
    idx = eng.adopt_session(snap.uid, snap.pos, snap.tok)
    cost = _write_row(cluster, eng, snap, idx)
    cluster.residence[snap.uid] = replica
    return cost


def repair_row(cluster, snap: SessionSnapshot,
               replica: int) -> Optional[MV.MovementCost]:
    """Heal the PHYSICAL row behind a (possibly shared) snapshot in place.

    Stages the carrier's pages + sidecar host→device and overwrites the row
    ``snap.uid`` currently resolves to — fork table, refcounts and every
    alias's host metadata untouched.  This is the pre-resume repair for a
    corrupt SHARED row: a shared row's bytes are immutable while shared
    (divergence write-breaks onto a fresh row first), so the carrier's
    snapshot matches the row by construction and one staged copy heals the
    whole family — :func:`restore_session` would instead re-admit the
    carrier, demoting the still-corrupt row to the siblings.  Returns the
    staging cost, or None when ``snap`` carries no pages or its uid no
    longer owns a row on ``replica``."""
    eng = cluster.replicas[replica]
    if snap.pages is None or snap.uid not in eng.session_pos:
        return None
    idx = (eng.forks.resolve(snap.uid) if snap.uid in eng.forks
           else snap.uid % eng.n_sessions)
    return _write_row(cluster, eng, snap, idx)


# ---------------------------------------------------------------------------
# disk persistence (the checkpoint manager's atomic format + crc trailer)
# ---------------------------------------------------------------------------

def save_snapshots(snaps: Dict[int, SessionSnapshot], ckpt_dir: str,
                   step: int, keep_last: int = 3) -> str:
    """Persist a snapshot set through
    :func:`repro_torch.checkpoint.manager.save` (atomic rename + crc
    trailer): a crash mid-save can never produce a restorable-but-torn
    snapshot directory."""
    tree = {}
    for s in snaps.values():
        alias = -1 if s.alias_of is None else s.alias_of
        entry = {"meta": np.array([s.pos, s.tok, alias], np.int64)}
        if s.pages is not None:
            # alias entries persist meta-only: the carrier's row is the
            # one copy of the shared bytes on disk, exactly as in memory
            entry["pages"] = s.pages
            entry["sums"] = s.sums
        tree[f"u{s.uid}"] = entry
    return CM.save(tree, ckpt_dir, step, keep_last=keep_last)


def load_snapshots(ckpt_dir: str,
                   step: Optional[int] = None) -> Dict[int, SessionSnapshot]:
    """Load a persisted snapshot set, trailer-verified first: a torn or
    truncated directory raises :class:`repro_torch.checkpoint.manager.
    CorruptCheckpoint` instead of yielding garbage sessions."""
    if step is None:
        step = CM.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no snapshots in {ckpt_dir}")
    CM.verify_checkpoint(ckpt_dir, step)
    data = np.load(os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz"))
    out: Dict[int, SessionSnapshot] = {}
    uids = sorted({int(k.split("/")[0][1:]) for k in data.files})
    for uid in uids:
        meta = [int(x) for x in data[f"u{uid}/meta"]]
        # length-2 metas predate fork-aware snapshots — accept them
        pos, tok = meta[0], meta[1]
        alias = meta[2] if len(meta) > 2 else -1
        has_pages = f"u{uid}/pages" in data.files
        out[uid] = SessionSnapshot(
            uid, pos, tok,
            data[f"u{uid}/pages"] if has_pages else None,
            data[f"u{uid}/sums"] if has_pages else None,
            alias_of=None if alias < 0 else alias)
    return out
