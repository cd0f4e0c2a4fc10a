# Port of src/repro/fork/table.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""Refcounted copy-on-write page aliasing — the RowClone analogue's ledger.

A :class:`ForkPageTable` is pure host bookkeeping over the uint8 page
substrate: sessions (logical uids) map onto *physical* slow-pool rows, and
N sessions may alias ONE physical row after a fork.  The table never
touches device memory — it decides *which* row a movement plan reads or
writes, so the fork fast path is zero device dispatches (RowClone FPM: a
row copy that never crosses the channel), and the real copy is deferred
until a writer diverges (:meth:`write_break`, the CoW detach — RowClone
PSM / a LISA hop chain when the copy crosses subarrays).

Invariants (the refcount-conservation property, asserted by
:meth:`check_conserved` and the hypothesis stream test):

  * every mapped uid resolves to exactly one physical row;
  * ``set(phys_of.values()) == set(refs.keys())`` — no orphan refcounts,
    no unaccounted rows;
  * ``sum(refs.values()) == len(phys_of)`` — each alias is counted once;
  * a row's refcount hits zero exactly when its last alias releases
    (:meth:`release` returns the freed row then, and only then).

All mutation of alias structure goes through this API; the
`unrefcounted-alias` repro-lint rule fails any serving code path that
scatters into or frees fork-owned rows around it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple


class ForkPageTable:
    """Host-side refcounted logical->physical page-row map for one store."""

    def __init__(self) -> None:
        self.phys_of: Dict[int, int] = {}    # uid -> physical row
        self.refs: Dict[int, int] = {}       # physical row -> alias count

    # ---- reads -------------------------------------------------------------
    def __contains__(self, uid: int) -> bool:
        return uid in self.phys_of

    def __len__(self) -> int:
        return len(self.phys_of)

    def resolve(self, uid: int) -> int:
        """The physical row backing ``uid`` (KeyError if unmapped)."""
        return self.phys_of[uid]

    def refcount(self, uid: int) -> int:
        """Aliases of the row backing ``uid`` (0 if unmapped)."""
        phys = self.phys_of.get(uid)
        return 0 if phys is None else self.refs[phys]

    def shared(self, uid: int) -> bool:
        """True when ``uid``'s row is aliased by at least one other uid."""
        return self.refcount(uid) > 1

    def aliases(self, phys: int) -> Tuple[int, ...]:
        """All uids aliasing physical row ``phys``, sorted."""
        return tuple(sorted(u for u, p in self.phys_of.items() if p == phys))

    def shared_rows(self) -> Dict[int, int]:
        """``{phys: refcount}`` for every row with refcount > 1."""
        return {p: n for p, n in self.refs.items() if n > 1}

    # ---- mutation (the refcount API the lint rule guards) ------------------
    def bind(self, uid: int, phys: int) -> None:
        """Claim ``phys`` exclusively for ``uid`` (a fresh suspend home).

        ``uid`` must be unmapped and ``phys`` unowned: rebinding a live
        alias or stealing an owned row would silently leak or double-count
        — both raise.
        """
        if uid in self.phys_of:
            raise ValueError(f"uid {uid} already mapped to row "
                             f"{self.phys_of[uid]}; release it first")
        if phys in self.refs:
            raise ValueError(f"row {phys} already owned by "
                             f"{self.aliases(phys)}")
        self.phys_of[uid] = phys
        self.refs[phys] = 1

    def fork_child(self, parent_uid: int, child_uid: int) -> int:
        """Alias ``child_uid`` onto the parent's row: refcount += 1, zero
        allocation, zero device work.  Returns the shared physical row."""
        if child_uid in self.phys_of:
            raise ValueError(f"child uid {child_uid} already mapped")
        phys = self.phys_of[parent_uid]
        self.phys_of[child_uid] = phys
        self.refs[phys] += 1
        return phys

    def write_break(self, uid: int,
                    alloc: Optional[Callable[[int], int]] = None) -> int:
        """CoW detach: return a row ``uid`` may WRITE exclusively.

        Exclusive already -> its current row (the fast path, no copy).
        Shared -> detach: the other aliases keep the old row (refcount -= 1)
        and ``uid`` claims ``alloc(uid)``, a fresh row the caller provides
        (the caller owns placement and performs any data copy — this table
        only does bookkeeping).  ``alloc`` is required exactly when shared.
        """
        phys = self.phys_of[uid]
        if self.refs[phys] == 1:
            return phys
        if alloc is None:
            raise ValueError(f"uid {uid} shares row {phys} with "
                             f"{self.aliases(phys)}; an alloc callback is "
                             f"required to detach")
        new_phys = alloc(uid)
        if new_phys in self.refs:
            raise ValueError(f"alloc returned owned row {new_phys}")
        # alloc may itself have DEMOTED the shared row to free its index
        # (when uid's home row IS the shared row): re-resolve before
        # decrementing so the bookkeeping follows the repoint.
        phys = self.phys_of[uid]
        self.refs[phys] -= 1
        self.phys_of[uid] = new_phys
        self.refs[new_phys] = 1
        return new_phys

    def repoint(self, old_phys: int, new_phys: int) -> Tuple[int, ...]:
        """Move EVERY alias of ``old_phys`` onto ``new_phys`` (a shared-row
        demotion: the caller migrated the bytes; aliases follow as one
        unit, refcount preserved).  Returns the moved uids."""
        if new_phys in self.refs:
            raise ValueError(f"row {new_phys} already owned by "
                             f"{self.aliases(new_phys)}")
        moved = self.aliases(old_phys)
        if not moved:
            raise KeyError(f"row {old_phys} has no aliases")
        for u in moved:
            self.phys_of[u] = new_phys
        self.refs[new_phys] = self.refs.pop(old_phys)
        return moved

    def release(self, uid: int) -> Optional[int]:
        """Drop ``uid``'s alias; returns the physical row iff this was the
        LAST alias (the row is now free to destroy), else None."""
        phys = self.phys_of.pop(uid)
        self.refs[phys] -= 1
        if self.refs[phys] == 0:
            del self.refs[phys]
            return phys
        return None

    def clear(self) -> None:
        """Forget everything (replica failure: the rows died with it)."""
        self.phys_of.clear()
        self.refs.clear()

    # ---- invariants --------------------------------------------------------
    def check_conserved(self) -> None:
        """Assert the conservation identities; raises AssertionError with
        the full state on any violation (used by the property tests after
        every step of a random fork/write/evict/release stream)."""
        targets = set(self.phys_of.values())
        assert targets == set(self.refs), (
            f"alias targets {sorted(targets)} != refcounted rows "
            f"{sorted(self.refs)}")
        assert sum(self.refs.values()) == len(self.phys_of), (
            f"refcounts {self.refs} don't sum to {len(self.phys_of)} aliases")
        for p, n in self.refs.items():
            assert n >= 1, (p, n)
            assert len(self.aliases(p)) == n, (p, n, self.aliases(p))
