# Port of src/repro/serve/engine.py:64-881 in torch.  Not ported yet:
# adopt_jits / compile_counts (no jit to share or count), step_unbatched (an
# A/B-only path), attach_tracer and shared_uids (used by the obs layer and
# the scheduler, which come with the next slice), and the cluster-facing
# session_meta / adopt_session / adopt_alias / drop_session / degrade_fast,
# which arrive with the cluster slice.
"""Continuous-batching decode engine with LISA-VILLA session caching.

The serving data path stays on the device:

  * ``step`` — one batched decode for the whole ragged batch and ONE
    device->host read per step (``step_end``'s tokens): per-slot positions
    and the active mask are data, greedy sampling runs on the device, and
    the KV cache is written in place, one token per active slot.
  * suspend / resume — planned movement: each is a ``movement.Transfer``
    between the compute tier and the VILLA slow tier, lowered once at
    construction by ``movement.plan`` into pack + tier legs and executed by
    ``movement.execute``.  Snapshots live as dtype-preserving uint8 pages
    (``serve/paged_store``) moved by the page kernels; the tier legs run the
    paper's promotion policy with its outcomes kept on the device, so a
    suspend or resume never waits for the card.
  * prefill — lengths are bucketed (next power of two); pads carry sentinel
    positions so they stay causally invisible forever.

Every plan carries a ``MovementCost`` priced by the engine's
:class:`~repro_torch.core.dram.spec.DramSpec` under the ``lisa`` vs
``memcpy`` mechanisms, and each suspend/resume charges its plan's cost.

Device: the engine runs on ``cuda`` unless ``device="cpu"`` is passed; it
raises without a GPU otherwise.  Parameters are moved to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import movement as MV
from repro_torch import resolve_device, to_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dram.spec import DDR3_1600, DramSpec
from repro_torch.core.dram.villa import VillaConfig
from repro_torch.core.lisa import villa_cache as VC
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.serve import paged_store as PS

POS_SENTINEL = 2**30     # matches the cache init sentinel in models/lm.py


class EngineFull(RuntimeError):
    """No free slot: the caller should drain a slot (or queue) and retry."""


class UnknownSession(KeyError):
    """resume() of a uid that was never suspended (or has been evicted)."""


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray
    max_new: int
    generated: Optional[List[int]] = None
    # scheduling metadata (arrival, priority class, latency SLO), carried
    # for the scheduler; plain engine use ignores them
    arrival_ns: float = 0.0
    priority: int = 0
    slo_ns: float = float("inf")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class Engine:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 128, n_sessions: int = 64,
                 villa: Optional[VillaConfig] = None,
                 spec: DramSpec = DDR3_1600, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _tree_to(params, self.device)
        self.spec = spec
        self.slots = slots
        self.max_len = max_len
        self.n_sessions = n_sessions
        self.active: Dict[int, Request] = {}        # slot -> request
        self.pos = np.zeros(slots, np.int32)

        self.cache = lm.init_cache(cfg, slots, max_len=max_len,
                                   device=self.device)
        # Prefill-length bucketing is sound when every layer's cache slot
        # for token t is position-addressed (full attention / MLA).
        self._can_bucket = (not cfg.encdec and not cfg.mrope and
                            all(k in ("attn_full", "mla")
                                for k in cfg.layer_kinds()))

        # Session store: suspended KV snapshots as dtype-preserving uint8
        # pages in a VILLA tiered store (movement via the page kernels).
        self.page_spec = PS.PageSpec.for_cache(self.cache)
        self.villa_cfg = villa or VillaConfig(
            n_counters=n_sessions, n_hot=max(n_sessions // 4, 2),
            n_slots=max(n_sessions // 4, 2), epoch_len=8)
        self.sessions = PS.make_session_store(self.page_spec, n_sessions,
                                              self.villa_cfg, self.device)
        self.session_pos: Dict[int, int] = {}       # uid -> next position
        self.session_tok: Dict[int, int] = {}       # uid -> last emitted token
        self.store_uid: Dict[int, int] = {}         # phys row -> owner uid
        # CoW alias ledger: logical uids -> physical store rows, refcounted.
        self.forks = PS.make_fork_table()
        # Detection sidecar: per-page checksums (uint32 values held in
        # int64) of every suspended snapshot, written at suspend and
        # verified at resume; ``verify_failed`` accumulates ON DEVICE.
        self.session_sums = torch.zeros(
            (n_sessions, self.page_spec.n_pages), dtype=torch.int64,
            device=self.device)
        self.verify_failed = torch.zeros((), dtype=torch.int32,
                                         device=self.device)

        _layout = MV.Layout.pages(self.page_spec)
        self.plan_suspend = MV.plan(MV.Transfer(
            MV.Tier("compute"), MV.Tier("slow"), _layout,
            policy=self.villa_cfg), spec)
        self.plan_resume = MV.plan(MV.Transfer(
            MV.Tier("slow"), MV.Tier("compute"), _layout,
            policy=self.villa_cfg), spec)
        self.plan_fork = MV.plan(MV.Transfer(
            MV.Tier("slow"), MV.Tier("slow"), _layout, kind="fork"), spec)
        self.plan_demote = self.plan_fork
        self._wave_plans: Dict[tuple, MV.MovementPlan] = {}
        self.snapshot_bytes = self.page_spec.total_bytes
        self.stats = {"decoded_tokens": 0, "prefills": 0, "suspends": 0,
                      "resumes": 0,
                      "decode_dispatches": 0, "host_transfers": 0,
                      "evictions": 0, "demotions": 0,
                      "forks": 0, "bytes_not_copied": 0,
                      "modeled_move_ns_lisa": 0.0,
                      "modeled_move_ns_memcpy": 0.0}

    def _dev(self, x, dtype=torch.int32) -> torch.Tensor:
        return to_device(x, self.device, dtype)

    # ---- device bodies (in-place updates of cache, pools and sidecar) -----
    def _prefill_insert(self, tokens: np.ndarray, positions: np.ndarray,
                        true_len: int, slot: int) -> int:
        """Prefill one request straight into ``slot`` (reset to init values
        first, as the reference's whole-slot insert leaves it) and return
        its next token — the one sync of a submit, as in the reference."""
        lm.reset_slot(self.cache, slot)
        logits, _ = lm.prefill(self.cfg, self.params,
                               self._dev(tokens)[None], self.cache,
                               positions=self._dev(positions)[None],
                               slot=slot)
        return int(torch.argmax(logits[0, true_len - 1]))

    def _suspend_fn(self, slot: int, idx: int) -> None:
        env = MV.execute(self.plan_suspend, cache=self.cache, slot=slot,
                         store=self.sessions, item=self._dev(idx))
        self.sessions = env["store"]
        # the pack leg emitted per-page checksums; persist them in the
        # sidecar row for this store index
        self.session_sums[idx] = env["sums"]

    def _resume_fn(self, slot: int, idx: int) -> None:
        env = MV.execute(self.plan_resume, cache=self.cache,
                         store=self.sessions, slot=slot, item=self._dev(idx),
                         sums=self.session_sums[idx])
        self.sessions = env["store"]
        self.verify_failed += env["verify_fail"]

    def _wave_plan(self, single: MV.MovementPlan, k: int) -> MV.MovementPlan:
        """A whole wave as ONE fused plan (k identical transfers)."""
        key = (id(single), k)
        if key not in self._wave_plans:
            self._wave_plans[key] = MV.fuse([single] * k)
        return self._wave_plans[key]

    def _suspend_many_fn(self, slots: List[int], idxs: List[int]) -> None:
        env = MV.execute(self._wave_plan(self.plan_suspend, len(slots)),
                         cache=self.cache, slots=slots, store=self.sessions,
                         items=self._dev(idxs))
        self.sessions = env["store"]
        self.session_sums[self._dev(idxs, torch.long)] = env["sums"]

    def _resume_many_fn(self, slots: List[int], idxs: List[int]) -> None:
        ii = self._dev(idxs, torch.long)
        env = MV.execute(self._wave_plan(self.plan_resume, len(slots)),
                         cache=self.cache, store=self.sessions, slots=slots,
                         items=ii, sums=self.session_sums.index_select(0, ii))
        self.sessions = env["store"]
        self.verify_failed += env["verify_fail"]

    def _clone_fn(self, src: int, dst: int) -> None:
        """Shared-row demotion body: clone slow row src -> dst (pages AND
        checksum sidecar); the fork table repoints the aliases right
        after."""
        self.sessions = VC.clone_item(self.sessions, self._dev(src),
                                      self._dev(dst))
        self.session_sums[dst] = self.session_sums[src]

    # ---- scheduling -------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [s for s in range(self.slots) if s not in self.active]

    def _take_slot(self) -> int:
        free = self.free_slots()
        if not free:
            raise EngineFull(
                f"all {self.slots} slots busy; suspend or finish a request "
                f"first (active uids: {[r.uid for r in self.active.values()]})")
        return free[0]

    def _bucket_len(self, n: int) -> int:
        if not self._can_bucket:
            return n
        return min(max(16, 1 << (n - 1).bit_length()), self.max_len)

    def submit(self, req: Request) -> int:
        slot = self._take_slot()
        n = len(req.prompt)
        if n > self.max_len:
            raise ValueError(f"prompt length {n} exceeds max_len={self.max_len}")
        req.generated = []
        lb = self._bucket_len(n)
        toks = np.zeros(lb, np.int32)
        toks[:n] = req.prompt
        pos_arr = np.full(lb, POS_SENTINEL, np.int32)
        pos_arr[:n] = np.arange(n)
        nxt = self._prefill_insert(toks, pos_arr, n, slot)
        req.generated.append(nxt)
        self.stats["prefills"] += 1
        self.active[slot] = req
        self.pos[slot] = n
        if len(req.generated) >= req.max_new:
            # a max_new=1 request is completed by the prefill token itself
            self.suspend(slot)
        return slot

    def step_begin(self):
        """Issue the tick's batched decode and return the in-flight device
        handle (None when idle).  The launches are asynchronous: the host is
        free to plan the next wave while the device decodes.  Pair with
        :meth:`step_end`."""
        if not self.active:
            return None
        toks = np.zeros(self.slots, np.int32)
        mask = np.zeros(self.slots, bool)
        for s, req in self.active.items():
            toks[s] = req.generated[-1]
            mask[s] = True
        over = [s for s in self.active if self.pos[s] >= self.max_len]
        if over:
            # the cache write would land past max_len: the reference drops
            # it silently (JAX OOB semantics); on CUDA it would corrupt
            # memory, so refuse
            raise ValueError(f"slots {over} are at max_len={self.max_len}; "
                             f"suspend them before decoding further")
        nxt_dev, self.cache = lm.decode_step_batched(
            self.cfg, self.params, self.cache, self._dev(toks),
            self._dev(self.pos), mask)
        self.stats["decode_dispatches"] += 1
        return nxt_dev

    def step_end(self, handle) -> List:
        """Sync one in-flight decode (the tick's ONE device->host read), run
        token bookkeeping, and suspend completed requests — a burst
        completes as ONE fused ``suspend_many`` wave.  Returns the
        ``(slot, request)`` pairs that completed this step."""
        if handle is None:
            return []
        nxt = handle.cpu().numpy()              # the one device->host read
        self.stats["host_transfers"] += 1
        for s in self.active:
            self.active[s].generated.append(int(nxt[s]))
            self.pos[s] += 1
            self.stats["decoded_tokens"] += 1
        done = [s for s, req in self.active.items()
                if len(req.generated) >= req.max_new]
        completed = [(s, self.active[s]) for s in done]
        if len(done) == 1:
            self.suspend(done[0])
        elif done:                        # burst completion: ONE fused wave
            self.suspend_many(done)
        return completed

    def step(self) -> List:
        """Decode one token for every active slot; ``step_end(step_begin())``
        with nothing overlapped."""
        return self.step_end(self.step_begin())

    # ---- VILLA session tiering (fork-aware row allocation) ----------------
    def _claim_row(self, uid: int) -> int:
        """Free the home index (uid % n_sessions) for ``uid``'s next write
        and return it.  An EXCLUSIVE occupant is destroy-evicted; a SHARED
        occupant is *demoted* (bytes device-cloned to a free row, every
        alias repointed), never destroyed."""
        idx = uid % self.n_sessions
        owner = self.store_uid.get(idx)
        if owner is not None and owner != uid:
            if self.forks.refs.get(idx, 0) > 1:
                self._demote_row(idx)
            else:
                self._evict_row(idx)
        elif owner == uid and idx in self.forks.refs:
            # uid's own home is the shared row it is detaching from
            self._demote_row(idx)
        assert idx not in self.forks.refs, (idx, self.forks.refs)
        return idx

    def _evict_row(self, idx: int) -> None:
        """Destroy the exclusive snapshot occupying ``idx``."""
        old = self.store_uid.pop(idx)
        self.session_pos.pop(old, None)
        self.session_tok.pop(old, None)
        if old in self.forks and self.forks.resolve(old) == idx:
            self.forks.release(old)
        self.stats["evictions"] += 1

    def _demote_row(self, src: int) -> None:
        """Migrate a SHARED row out of the way: device-clone its pages and
        checksum sidecar to a free row, repoint every alias as one unit."""
        free = [i for i in range(self.n_sessions)
                if i not in self.forks.refs and i not in self.store_uid]
        if not free:
            raise RuntimeError(
                f"store full: cannot demote shared row {src} "
                f"(aliases {self.forks.aliases(src)}); drop a session first")
        dst = free[0]
        self._clone_fn(src, dst)
        self.forks.repoint(src, dst)
        self.store_uid[dst] = self.store_uid.pop(src)
        self.stats["demotions"] += 1
        self._charge_move(self.plan_demote)

    def _own_row(self, uid: int, idx: int) -> None:
        """Post-write bookkeeping: a fresh uid binds its claimed row; any row
        ``uid`` no longer backs is handed to a surviving alias."""
        if uid not in self.forks:
            self.forks.bind(uid, idx)
        for phys in [p for p, o in self.store_uid.items()
                     if o == uid and p != idx]:
            alts = [a for a in self.forks.aliases(phys) if a != uid]
            if alts:
                self.store_uid[phys] = alts[0]
            else:
                del self.store_uid[phys]
        self.store_uid[idx] = uid

    def _suspend_bookkeep(self, slot: int) -> int:
        """Pop the request off ``slot`` and record its session state."""
        req = self.active.pop(slot)
        self.session_pos[req.uid] = int(self.pos[slot])
        self.session_tok[req.uid] = req.generated[-1] if req.generated else 0
        self.stats["suspends"] += 1
        return req.uid

    def suspend(self, slot: int) -> None:
        if slot not in self.active:
            raise ValueError(f"slot {slot} has no active request to suspend "
                             f"(active slots: {sorted(self.active)})")
        uid = self._suspend_bookkeep(slot)
        # CoW write-break BEFORE the scatter
        idx = (self.forks.write_break(uid, alloc=self._claim_row)
               if uid in self.forks else self._claim_row(uid))
        self._own_row(uid, idx)
        self._suspend_fn(slot, idx)
        self._charge_move(self.plan_suspend)

    def suspend_many(self, slots: Sequence[int]) -> None:
        """Suspend a wave of slots through the fused suspend plan: one
        packed (k, pages) buffer + one write-through wave."""
        if not slots:
            return
        bad = [s for s in slots if s not in self.active]
        if bad or len(set(slots)) != len(slots):
            raise ValueError(f"suspend wave needs distinct active slots "
                             f"(got {list(slots)}; active: "
                             f"{sorted(self.active)})")
        uids = [self._suspend_bookkeep(s) for s in slots]
        idxs = []
        for uid in uids:
            idx = (self.forks.write_break(uid, alloc=self._claim_row)
                   if uid in self.forks else self._claim_row(uid))
            self._own_row(uid, idx)
            idxs.append(idx)
        self._suspend_many_fn(list(slots), idxs)
        self._charge_move(self._wave_plan(self.plan_suspend, len(slots)))

    def _check_resumable(self, uid: int, extra_new: int) -> int:
        for slot, r in self.active.items():
            if r.uid == uid:
                raise ValueError(
                    f"uid {uid} is already active in slot {slot}; suspend it "
                    f"before resuming it again (a second resume would fork a "
                    f"stale snapshot and corrupt suspend bookkeeping)")
        if uid not in self.session_pos:
            raise UnknownSession(
                f"uid {uid} has no suspended session (never suspended, or "
                f"evicted by a store-index collision)")
        pos = self.session_pos[uid]
        if pos + extra_new - 1 > self.max_len:
            # decode step k writes the cache at position pos+k: past max_len
            # the write would leave the cache (refused, never dropped)
            raise ValueError(
                f"uid {uid} is at position {pos}: decoding {extra_new - 1} "
                f"more tokens would write past max_len={self.max_len}; "
                f"clamp extra_new to the context envelope")
        # the PHYSICAL row: a forked child resumes by gathering straight
        # from the parent's shared row (read-through aliasing)
        return self.forks.resolve(uid)

    def _activate(self, slot: int, uid: int, extra_new: int) -> None:
        req = Request(uid=uid, prompt=np.zeros(0, np.int32), max_new=extra_new)
        req.generated = [self.session_tok[uid]]
        self.active[slot] = req
        self.pos[slot] = self.session_pos[uid]
        if len(req.generated) >= req.max_new:
            # extra_new <= 1: the restored seed token already meets the
            # budget — suspend instead of overshooting by one decode
            self.suspend(slot)

    def resume(self, uid: int, extra_new: int) -> int:
        """Bring a suspended session back: the tiered-store access promotes
        hot sessions to the fast tier.  No host sync."""
        idx = self._check_resumable(uid, extra_new)
        slot = self._take_slot()
        self._resume_fn(slot, idx)
        self._activate(slot, uid, extra_new)
        self.stats["resumes"] += 1
        self._charge_move(self.plan_resume)
        return slot

    def resume_many(self, uids: Sequence[int], extra_new) -> List[int]:
        """Resume a wave of sessions through one fused plan.  ``extra_new``
        is an int for every session, or a per-uid sequence."""
        if not uids:
            return []
        if len(set(uids)) != len(uids):
            raise ValueError(f"duplicate uids in resume wave: {list(uids)}")
        extras = ([int(extra_new)] * len(uids)
                  if isinstance(extra_new, (int, np.integer))
                  else [int(e) for e in extra_new])
        if len(extras) != len(uids):
            raise ValueError(f"extra_new sequence has {len(extras)} entries "
                             f"for {len(uids)} uids")
        idxs = [self._check_resumable(u, e) for u, e in zip(uids, extras)]
        free = self.free_slots()
        if len(free) < len(uids):
            raise EngineFull(f"{len(uids)} resumes requested but only "
                             f"{len(free)} slots free")
        slots = free[:len(uids)]
        self._resume_many_fn(slots, idxs)
        for slot, uid, extra in zip(slots, uids, extras):
            self._activate(slot, uid, extra)
            self.stats["resumes"] += 1
        self._charge_move(self._wave_plan(self.plan_resume, len(uids)))
        return slots

    def _charge_move(self, plan: MV.MovementPlan) -> None:
        """Account one executed plan under both mechanisms."""
        self.stats["modeled_move_ns_lisa"] += plan.cost.ns_lisa
        self.stats["modeled_move_ns_memcpy"] += plan.cost.ns_memcpy

    # ---- zero-copy session forking (RowClone analogue) --------------------
    def fork_many(self, parent_uid: int, child_uids: Sequence[int],
                  seed_tokens: Optional[Sequence[int]] = None) -> None:
        """Fork N children off a SUSPENDED parent: each child aliases the
        parent's physical snapshot row and inherits its position — host
        bookkeeping only, zero device launches.  ``seed_tokens`` overrides
        each child's first decode input."""
        if not child_uids:
            return
        if parent_uid not in self.session_pos:
            raise UnknownSession(
                f"uid {parent_uid} has no suspended session to fork "
                f"(suspend the parent first — fork aliases its snapshot)")
        for slot, r in self.active.items():
            if r.uid == parent_uid:
                raise ValueError(
                    f"parent uid {parent_uid} is active in slot {slot}; "
                    f"suspend it before forking (the snapshot row must be "
                    f"quiescent)")
        if len(set(child_uids)) != len(child_uids):
            raise ValueError(f"duplicate child uids: {list(child_uids)}")
        taken = [c for c in child_uids
                 if c == parent_uid or c in self.session_pos
                 or c in self.forks
                 or any(r.uid == c for r in self.active.values())]
        if taken:
            raise ValueError(f"child uids already in use: {taken}")
        seeds = (list(seed_tokens) if seed_tokens is not None
                 else [self.session_tok[parent_uid]] * len(child_uids))
        if len(seeds) != len(child_uids):
            raise ValueError(f"{len(seeds)} seed tokens for "
                             f"{len(child_uids)} children")
        for child, seed in zip(child_uids, seeds):
            self.forks.fork_child(parent_uid, child)
            self.session_pos[child] = self.session_pos[parent_uid]
            self.session_tok[child] = int(seed)
        fplan = self._wave_plan(self.plan_fork, len(child_uids))
        self._charge_move(fplan)
        self.stats["forks"] += len(child_uids)
        self.stats["bytes_not_copied"] += fplan.cost.bytes

    def fork(self, parent_uid: int, child_uid: int,
             seed_token: Optional[int] = None) -> None:
        """Fork ONE child — see :meth:`fork_many`."""
        self.fork_many(parent_uid, [child_uid],
                       None if seed_token is None else [seed_token])

    def reseed(self, uid: int, token: int) -> None:
        """Override a suspended session's next decode input (host
        bookkeeping only)."""
        if uid not in self.session_pos:
            raise UnknownSession(f"uid {uid} has no suspended session")
        for slot, r in self.active.items():
            if r.uid == uid:
                raise ValueError(f"uid {uid} is active in slot {slot}")
        self.session_tok[uid] = int(token)

    def fast_resident_uids(self) -> frozenset:
        """uids whose snapshots are resident in the VILLA fast tier (one
        small device->host read of the policy tags)."""
        out = set()
        for t in self.sessions.policy.tags.cpu().tolist():
            if t < 0:
                continue
            if t in self.forks.refs:
                # a resident SHARED row makes every alias fast-resident
                out.update(self.forks.aliases(t))
            elif t in self.store_uid:
                out.add(self.store_uid[t])
        return frozenset(out)

    def hit_rate(self) -> float:
        return float(VC.hit_rate(self.sessions))

    # ---- chaos surface ----------------------------------------------------
    def corrupt_stored(self, idx: int, page: int, byte: int,
                       xor: int) -> None:
        """Chaos hook: XOR one byte of suspended snapshot ``idx`` at rest —
        in the slow pool AND, if the snapshot is fast-resident, in the fast
        copy.  The checksum sidecar is deliberately NOT updated.  Device
        ops only, no host sync."""
        P, d = self.page_spec.page_rows, self.page_spec.page_lanes
        row, lane = byte // d, byte % d
        if not (0 <= page < self.page_spec.n_pages and 0 <= row < P):
            raise ValueError(f"corrupt_stored target out of range: "
                             f"page={page}, byte={byte}")
        if not 0 <= idx < self.n_sessions:
            raise ValueError(f"corrupt_stored: no store row {idx}")
        st = self.sessions
        st.slow[idx, page, row, lane] ^= xor
        per_item = self.page_spec.n_pages * P * d
        flat = st.fast.view(-1)
        tags = st.policy.tags
        hit = (tags == idx).any()
        f = torch.argmax((tags == idx).to(torch.int32))    # the fast slot
        at = (f * per_item + (page * P + row) * d + lane).reshape(1)
        old = flat.index_select(0, at)
        flat.index_copy_(0, at, torch.where(hit, old ^ xor, old))

    def verify_store(self) -> torch.Tensor:
        """Scrub: recompute every LIVE suspended snapshot's checksums
        against the sidecar; returns the ON-DEVICE int32 count of corrupt
        PHYSICAL rows (a shared row is checked once).  The pages are read
        with the gather kernel."""
        idxs = sorted(i for i, u in self.store_uid.items()
                      if u in self.session_pos
                      or any(a in self.session_pos
                             for a in self.forks.aliases(i)))
        if not idxs:
            return torch.zeros((), dtype=torch.int32, device=self.device)
        spec = self.page_spec
        table = torch.cat([PS.row_page_table(spec, i) for i in idxs])
        slow = self.sessions.slow
        pages = ops.villa_gather(
            slow.view(-1, spec.page_rows, spec.page_lanes), table).view(
                len(idxs), spec.n_pages, spec.page_rows, spec.page_lanes)
        cs = PS.page_checksums(pages)
        want = self.session_sums.index_select(0, self._dev(idxs, torch.long))
        return torch.sum((cs != want).any(dim=-1)).to(torch.int32)

    def verify_failure_count(self) -> int:
        """Sync the device-side resume-verify counter (bench/test surface —
        one explicit read, outside the tick loop)."""
        return int(self.verify_failed)
