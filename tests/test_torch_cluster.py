"""The port's replica fleet (``repro_torch.serve.cluster``) and its
``ClusterScheduler`` against the reference's, on the same weights
(``params_from_jax``) and the same inputs: every test of
tests/test_cluster.py but the forced-host mesh one (the mesh's ppermute
chain is ROADMAP item 16), each run through both packages.  Tokens, stats,
residence, plan costs and exceptions must be equal; the scheduler's virtual
clock, ``lane_log``, decisions and summaries are host arithmetic and must be
equal float for float.  A migration route runs one page gather (K2) and one
page scatter (K1), counted at the movement backends."""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_fleet import ref_cluster

from repro import sched as R
from repro.configs import get_reduced
from repro.models import lm as R_lm
from repro.serve.cluster import Cluster as RCluster
from repro.serve.engine import Request as RRequest
from repro.serve.engine import UnknownSession as RUnknown
from repro_torch import sched as P
from repro_torch.core.lisa.topology import MeshTopology
from repro_torch.models import lm as P_lm
from repro_torch.movement import registry as MR
from repro_torch.serve.cluster import Cluster as PCluster
from repro_torch.serve.engine import Request as PRequest
from repro_torch.serve.engine import UnknownSession as PUnknown
from repro_torch.weights import params_from_jax

VOCAB = get_reduced("tinyllama-1.1b").vocab_size


@pytest.fixture(scope="module")
def setup():
    cfg = get_reduced("tinyllama-1.1b")
    rparams = R_lm.init_lm(cfg, jax.random.key(0))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    return cfg, rparams, pparams


def _pair(setup, **kw):
    """The reference's cluster and the port's, built alike."""
    cfg, rparams, pparams = setup
    return (ref_cluster(cfg, rparams, **kw),
            PCluster(cfg, pparams, device="cpu", **kw))


def _greedy(cfg, params, prompt, n_new, max_len=96):
    """The uninterrupted greedy decode of ``prompt`` through the port's
    ``lm.prefill`` and ``lm.decode_step``."""
    cache = P_lm.init_cache(cfg, 1, max_len=max_len, device="cpu")
    logits, cache = P_lm.prefill(cfg, params,
                                 torch.from_numpy(prompt)[None], cache)
    toks = [int(torch.argmax(logits[0, -1]))]
    while len(toks) < n_new:
        lg, cache = P_lm.decode_step(cfg, params, cache,
                                     torch.tensor([[toks[-1]]]),
                                     len(prompt) + len(toks) - 1)
        toks.append(int(torch.argmax(lg[0, 0])))
    return toks


def _drain(cl, uid, prompt, max_new, replica):
    """Submit on ``replica``, run to completion (auto-suspend), return the
    request."""
    req = (RRequest if isinstance(cl, RCluster) else PRequest)(
        uid=uid, prompt=prompt, max_new=max_new)
    cl.submit(req, replica=replica)
    while cl.active:
        cl.step()
    return req


@pytest.fixture
def route_calls(monkeypatch):
    """Counts of the page_gather and page_scatter backends' calls (K2 and
    K1 launches on the card), whatever wrapper is installed over them."""
    calls = {"page_gather": 0, "page_scatter": 0}
    for kind in calls:
        inner = MR._BACKENDS[kind]

        def counted(leg, env, kind=kind, inner=inner):
            calls[kind] += 1
            return inner(leg, env)
        monkeypatch.setitem(MR._BACKENDS, kind, counted)
    return calls


def _same_state(rc, pc):
    assert pc.residence == rc.residence
    assert pc.cluster_stats == rc.cluster_stats
    assert pc.stats == rc.stats
    assert pc.session_pos == rc.session_pos
    for re_, pe in zip(rc.replicas, pc.replicas):
        assert pe.session_tok == re_.session_tok
        assert pe.store_uid == re_.store_uid


# ---------------------------------------------------------------------------
# live migration: bit-exactness and loss-freedom
# ---------------------------------------------------------------------------

def test_migrated_decode_matches_uninterrupted(setup, route_calls):
    """suspend on replica 0 -> migrate -> resume on replica 2 gives the
    uninterrupted decode's tokens, and the reference's; the route is one
    K2 and one K1."""
    cfg = setup[0]
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, 9).astype(np.int32)
    straight = _greedy(cfg, setup[2], prompt, 8)
    got = []
    for cl in _pair(setup, n_replicas=4, slots=2, max_len=96, n_sessions=8):
        req = _drain(cl, 7, prompt, 4, replica=0)
        before = dict(route_calls)
        cl.migrate(7, 2)
        if isinstance(cl, PCluster):
            assert route_calls == {k: v + 1 for k, v in before.items()}
        assert cl.residence[7] == 2
        assert 7 not in cl.replicas[0].session_pos
        assert 7 in cl.replicas[2].session_pos
        slot = cl.resume(7, extra_new=5)
        assert cl.replica_of(slot) == 2
        r2 = cl.active[slot]
        while cl.active:
            cl.step()
        got.append(req.generated + r2.generated[1:])
        assert cl.cluster_stats["migrations"] == 1
    assert got[1] == got[0] == straight


def test_migration_moves_the_exact_snapshot_bytes(setup):
    """The migrated page block lands in the destination pool bit for bit,
    with its checksum row, and the migrated-bytes count is the
    reference's."""
    cfg = setup[0]
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, 7).astype(np.int32)
    rc, pc = _pair(setup, n_replicas=2, slots=2, max_len=96, n_sessions=8)
    for cl in (rc, pc):
        _drain(cl, 3, prompt, 3, replica=0)
    src_block = pc.replicas[0].sessions.slow[3].clone()
    src_sums = pc.replicas[0].session_sums[3].clone()
    rc.migrate(3, 1)
    pc.migrate(3, 1)
    dst_block = pc.replicas[1].sessions.slow[3]
    assert dst_block.dtype == src_block.dtype
    assert np.array_equal(dst_block.numpy(), src_block.numpy())
    assert np.array_equal(pc.replicas[1].session_sums[3].numpy(),
                          src_sums.numpy())
    # the source row is left as it was (a migration reads it, never writes)
    assert np.array_equal(pc.replicas[0].sessions.slow[3].numpy(),
                          src_block.numpy())
    _same_state(rc, pc)
    assert pc.cluster_stats["migrated_bytes"] == pc.snapshot_bytes > 0


def test_migrate_many_fuses_one_route_per_wave(setup, route_calls):
    """A rebalance burst of k sessions sharing a route is ONE gather and
    ONE scatter over a joined page table, not k of each."""
    cfg = setup[0]
    rc, pc = _pair(setup, n_replicas=4, slots=2, max_len=96, n_sessions=16)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
               for _ in range(4)]
    for cl in (rc, pc):
        for uid in range(4):
            _drain(cl, uid, prompts[uid], 3, replica=0)
    metas = {u: pc.replicas[0].session_meta(u) for u in range(4)}
    assert metas == {u: rc.replicas[0].session_meta(u) for u in range(4)}
    blocks = {u: pc.replicas[0].sessions.slow[u].clone() for u in range(4)}
    moves = [(0, 1), (1, 1), (2, 1), (3, 3)]
    rc.migrate_many(moves)
    before = dict(route_calls)
    pc.migrate_many(moves)
    assert route_calls == {k: v + 2 for k, v in before.items()}
    assert pc.cluster_stats["migration_waves"] == 2     # routes 0->1, 0->3
    for u, dst in moves:
        assert pc.residence[u] == dst
        assert pc.replicas[dst].session_meta(u) == metas[u]
        assert np.array_equal(pc.replicas[dst].sessions.slow[u].numpy(),
                              blocks[u].numpy())
    _same_state(rc, pc)
    assert tuple(pc.migration_plan(0, 1, 3).cost) == \
        tuple(rc.migration_plan(0, 1, 3).cost)


def test_migration_errors_are_loud(setup):
    """Bad moves raise the reference's exception types with its messages,
    before any state changes."""
    cfg = setup[0]
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
    for cl, unknown, Req in zip(
            _pair(setup, n_replicas=2, slots=2, max_len=96, n_sessions=8),
            (RUnknown, PUnknown), (RRequest, PRequest)):
        with pytest.raises(unknown):
            cl.migrate(9, 1)                   # never suspended anywhere
        cl.submit(Req(uid=0, prompt=prompt, max_new=10), replica=0)
        with pytest.raises(ValueError, match="active"):
            cl.migrate_many([(0, 1)])          # running sessions don't move
        while cl.active:
            cl.step()
        with pytest.raises(ValueError, match="real route"):
            cl.migrate(0, 0)                   # already home
        with pytest.raises(ValueError, match="duplicate"):
            cl.migrate_many([(0, 1), (0, 1)])
        with pytest.raises(ValueError, match="unknown destination"):
            cl.migrate(0, 5)
        with pytest.raises(ValueError, match="unknown replica"):
            cl.fail_replica(2)
        assert cl.cluster_stats["migrations"] == 0
    with pytest.raises(ValueError, match="topology size"):
        PCluster(cfg, setup[2], n_replicas=2, topo=MeshTopology(3),
                 device="cpu")


def test_migration_plan_costs_equal(setup):
    """Route plans (single sessions, waves of 3, fork materialization)
    price identically, leg for leg, and ``hop_ns`` agrees."""
    rc, pc = _pair(setup, n_replicas=4, slots=1, max_len=96, n_sessions=4)
    for dst, hops in [(1, 1), (2, 2), (3, 1)]:          # ring of 4
        for k in (1, 3):
            rp, pp = rc.migration_plan(0, dst, k), pc.migration_plan(0, dst, k)
            assert [l.kind for l in pp.legs] == ["page_gather", "hop_chain",
                                                 "page_scatter"]
            assert pp.legs[1].hops == hops
            assert tuple(pp.cost) == tuple(rp.cost)
            assert pp.cost.bytes == k * pc.snapshot_bytes
        assert tuple(pc._fork_route_plan(0, dst).cost) == \
            tuple(rc._fork_route_plan(0, dst).cost)
        for mech in ("lisa", "memcpy"):
            assert pc.hop_ns(0, dst, mech) == rc.hop_ns(0, dst, mech)
    assert pc.hop_ns(0, 0) == 0.0


def test_migration_invalidates_stale_fast_residency(setup):
    """An inbound migration that evicts a colliding store index also drops
    that index's fast-tier residency, so the next resume reads the
    migrated bytes, not the old session's."""
    cfg = setup[0]
    rng = np.random.default_rng(4)
    p1 = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
    p5 = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    straight = _greedy(cfg, setup[2], p5, 6)
    got = []
    for cl in _pair(setup, n_replicas=2, slots=2, max_len=96, n_sessions=4):
        _drain(cl, 1, p1, 3, replica=1)
        for _ in range(12):
            cl.resume(1, extra_new=2, replica=1)
            while cl.active:
                cl.step()
            if 1 in cl.replicas[1].fast_resident_uids():
                break
        assert 1 in cl.replicas[1].fast_resident_uids()
        assert cl.fast_occupancy()[1] > 0
        req5 = _drain(cl, 5, p5, 3, replica=0)
        cl.migrate(5, 1)
        assert 1 not in cl.replicas[1].fast_resident_uids()
        slot = cl.resume(5, extra_new=4)
        r5 = cl.active[slot]
        while cl.active:
            cl.step()
        got.append((req5.generated + r5.generated[1:], cl.fast_occupancy(),
                    cl.hit_rate()))
    assert got[1][0] == got[0][0] == straight
    assert got[1][1:] == pytest.approx(got[0][1:])


# ---------------------------------------------------------------------------
# fleet mechanics
# ---------------------------------------------------------------------------

def test_fleet_shares_one_copy_of_the_weights(setup):
    """Every replica's parameters are replica 0's tensors (the counterpart
    of the reference's shared jits), and a fleet step is one decode per
    replica with work."""
    cfg = setup[0]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 5 + r).astype(np.int32)
               for r in range(3)]
    rc, pc = _pair(setup, n_replicas=3, slots=1, max_len=96, n_sessions=8)

    def ptrs(tree):
        if isinstance(tree, dict):
            return [p for k in sorted(tree) for p in ptrs(tree[k])]
        return [tree.data_ptr()]
    want = ptrs(setup[2])
    for eng in pc.replicas:
        assert ptrs(eng.params) == want
    for cl, Req in ((rc, RRequest), (pc, PRequest)):
        for r in range(3):
            cl.submit(Req(uid=r, prompt=prompts[r], max_new=4), replica=r)
        before = cl.stats["decode_dispatches"]
        cl.step()
        assert cl.stats["decode_dispatches"] - before == 3
        while cl.active:
            cl.step()
    _same_state(rc, pc)


def test_cluster_engine_shaped_views(setup):
    cfg = setup[0]
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
    for cl, Req in zip(_pair(setup, n_replicas=2, slots=2, max_len=96,
                             n_sessions=8), (RRequest, PRequest)):
        assert cl.slots == 4 and len(cl.free_slots()) == 4
        g = cl.submit(Req(uid=0, prompt=prompt, max_new=5), replica=1)
        assert cl.replica_of(g) == 1 and g in cl.active
        assert cl.free_by_replica() == [2, 1]
        cl.suspend(g)
        assert cl.residence[0] == 1 and cl.session_pos[0] == len(prompt)
        slot = cl.resume(0, extra_new=2)
        assert cl.replica_of(slot) == 1
        while cl.active:
            cl.step()
        assert cl.fast_resident_uids() == frozenset()
        assert cl.shared_uids() == frozenset()


def test_cross_replica_fork_materializes(setup, route_calls):
    """A fork onto another replica copies the parent's row over the route
    (one K2, one K1): same tokens, stats and costs as the reference; a
    same-replica fork is an alias and launches nothing."""
    cfg = setup[0]
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab_size, 7).astype(np.int32)
    toks = []
    for cl in _pair(setup, n_replicas=2, slots=2, max_len=96, n_sessions=8):
        _drain(cl, 1, prompt, 2, replica=0)
        before = dict(route_calls)
        cl.fork(1, 2, replica=0, seed_token=11)
        cl.fork(1, 3, replica=1, seed_token=12)
        if isinstance(cl, PCluster):
            assert route_calls == {k: v + 1 for k, v in before.items()}
            assert np.array_equal(cl.replicas[1].sessions.slow[3].numpy(),
                                  cl.replicas[0].sessions.slow[1].numpy())
        assert cl.residence == {1: 0, 2: 0, 3: 1}
        assert cl.shared_uids() == frozenset({1, 2})
        slots = cl.resume_many([2, 3], 4)
        reqs = [cl.active[s] for s in slots]
        while cl.active:
            cl.step()
        toks.append([r.generated for r in reqs])
        assert cl.verify_failure_count() == 0
    assert toks[1] == toks[0]
    assert toks[1][0][0] == 11 and toks[1][1][0] == 12


# ---------------------------------------------------------------------------
# cluster scheduling: placement + migration as policy decisions
# ---------------------------------------------------------------------------

def _log_completions(cl, log):
    step_end = cl.step_end

    def logged(handles):
        done = step_end(handles)
        log.extend((req.uid, list(req.generated)) for _, req in done)
        return done
    cl.step_end = logged


def _sched_run(pkg, setup, make_arrivals, cl_kw, s_kw):
    cfg, rparams, pparams = setup
    ref = pkg is R
    cl = (ref_cluster(cfg, rparams, **cl_kw) if ref
          else PCluster(cfg, pparams, device="cpu", **cl_kw))
    tokens = []
    _log_completions(cl, tokens)
    s = pkg.ClusterScheduler(cl, arrivals=make_arrivals(pkg), **s_kw)
    summary = s.run()
    return s, cl, summary, tokens


def _same_sched_runs(r, p):
    (rs, rc, rsum, rtok), (ps, pc, psum, ptok) = r, p
    assert ([dataclasses.astuple(d) for d in ps.metrics.decisions]
            == [dataclasses.astuple(d) for d in rs.metrics.decisions])
    assert ps.lane_log == rs.lane_log
    assert psum == rsum
    assert (ps.tick_count, ps.now_ns) == (rs.tick_count, rs.now_ns)
    assert ([(j.job_id, j.uid, j.kind, j.done, j.state, j.done_ns,
              j.migrations) for j in ps.jobs()]
            == [(j.job_id, j.uid, j.kind, j.done, j.state, j.done_ns,
                 j.migrations) for j in rs.jobs()])
    assert ptok == rtok
    _same_state(rc, pc)


def _bench_stream(pkg):
    wl = pkg.WorkloadConfig(
        n_fresh=12, n_followups=24, mean_gap_ns=900.0, arrival="bursty",
        burst=4, zipf_s=1.4, think_ns=2500.0,
        class_slo_ns=(35_000.0, 120_000.0, math.inf))
    return wl, pkg.generate_workload(wl, seed=4, vocab_size=VOCAB)


# BENCH_cluster.json's four arms (benchmarks/run.py::bench_cluster)
ARMS = {
    "replicas1": (lambda pkg: _bench_stream(pkg)[1],
                  dict(n_replicas=1, slots=4, max_len=96), {}),
    "replicas4": (lambda pkg: _bench_stream(pkg)[1],
                  dict(n_replicas=4, slots=4, max_len=96), {}),
    "migration_on": (lambda pkg: pkg.skewed_residence_burst(VOCAB),
                     dict(n_replicas=4, slots=1, max_len=96,
                          n_sessions=128),
                     dict(migrate=True)),
    "migration_off": (lambda pkg: pkg.skewed_residence_burst(VOCAB),
                      dict(n_replicas=4, slots=1, max_len=96,
                           n_sessions=128),
                      dict(migrate=False)),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_bench_cluster_arm_matches_reference(setup, arm):
    make, cl_kw, s_kw = ARMS[arm]
    cl_kw = dict(cl_kw)
    cl_kw.setdefault("n_sessions", R.n_sessions_for(_bench_stream(R)[0]))
    if arm.startswith("migration"):
        s_kw = dict(s_kw, cfg=None)
    runs = []
    for pkg in (R, P):
        kw = dict(s_kw)
        if "cfg" in kw:
            kw["cfg"] = pkg.SchedConfig(age_every=64)
        runs.append(_sched_run(pkg, setup, make, cl_kw, kw))
    _same_sched_runs(*runs)
    s, cl, summary, _ = runs[1]
    assert all(j.state == "done" and j.done == j.target_new
               for j in s.jobs())
    assert len(summary["per_replica_utilization"]) == cl.n_replicas
    if arm == "migration_on":
        assert summary["migration"]["sessions_migrated"] >= 2
        assert cl.cluster_stats["migrations"] >= 2
    if arm == "migration_off":
        assert summary["migration"]["sessions_migrated"] == 0
        assert cl.cluster_stats["migrations"] == 0
        assert runs[1][2]["slo_attainment"] < 1.0


def test_cluster_scheduler_slot_conservation(setup):
    """The job map equals the engines' active maps, one slot per session,
    per-replica occupancy never exceeds slots_per_replica — ticked in step
    with the reference."""
    cfg = setup[0]
    runs = []
    for pkg in (R, P):
        wl = pkg.WorkloadConfig(n_fresh=6, n_followups=10, mean_gap_ns=900.0,
                                arrival="bursty", burst=3, zipf_s=1.4,
                                class_slo_ns=(25_000.0, 80_000.0, math.inf))
        arrivals = pkg.generate_workload(wl, seed=2,
                                         vocab_size=cfg.vocab_size)
        cl = (ref_cluster(cfg, setup[1], n_replicas=2, slots=2, max_len=96,
                          n_sessions=pkg.n_sessions_for(wl)) if pkg is R else
              PCluster(cfg, setup[2], n_replicas=2, slots=2, max_len=96,
                       n_sessions=pkg.n_sessions_for(wl), device="cpu"))
        s = pkg.ClusterScheduler(cl, arrivals=arrivals)
        clock = []
        while s.pending():
            s.tick()
            clock.append(s.now_ns)
            active = s.active_jobs()
            assert set(active) == set(cl.active)
            uids = [j.uid for j in active.values()]
            assert len(uids) == len(set(uids))
            for eng in cl.replicas:
                assert len(eng.active) <= eng.slots
            assert s.tick_count < 3000
        assert clock == sorted(clock)                   # clock monotone
        assert all(j.state == "done" and j.done == j.target_new
                   for j in s.jobs())
        for uid, r in cl.residence.items():
            assert uid in cl.replicas[r].session_pos
        runs.append((clock, s.lane_log, cl.residence))
    assert runs[1] == runs[0]


def test_cluster_placement_spreads_fresh_load(setup):
    """A simultaneous burst of fresh requests lands one per replica."""
    cfg = setup[0]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
               for _ in range(4)]
    for cl, pkg in zip(_pair(setup, n_replicas=4, slots=1, max_len=96,
                             n_sessions=8), (R, P)):
        arrivals = [pkg.Arrival(t_ns=0.0, uid=i, kind="fresh", priority=1,
                                slo_ns=math.inf, new_tokens=3,
                                prompt=prompts[i]) for i in range(4)]
        pkg.ClusterScheduler(cl, arrivals=arrivals).run()
        assert sorted(cl.residence.values()) == [0, 1, 2, 3]


def test_cluster_needs_a_gpu_or_device_cpu(setup, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PCluster(setup[0], setup[2], n_replicas=2, slots=1, max_len=96,
                 n_sessions=4)
