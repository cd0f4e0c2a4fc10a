"""The port's chaos layer (``repro_torch.faults``) and checkpoint manager
against the reference's: the fault modes bit for bit, the wrappers that
consume a wave's fault once, the source pool intact under a corrupted wave,
migrations with retries, at-rest corruption caught at resume, snapshot
restore after a replica failure (tokens equal to the reference's), the
chaos launcher's JSON with its fault ledger, and checkpoints that each
package writes and the other verifies and restores.  Same weights
(``params_from_jax``) and seeds in both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_fleet import ref_cluster

from repro import faults as RF
from repro import movement as R_MV
from repro import sched as R
from repro.checkpoint import manager as R_CM
from repro.configs import get_reduced
from repro.core.lisa.topology import MeshTopology as RTopo
from repro.launch.serve import main as r_main
from repro.models import lm as R_lm
from repro.serve.cluster import Cluster as RCluster
from repro.serve.engine import Request as RRequest
from repro_torch import faults as PF
from repro_torch import movement as P_MV
from repro_torch import sched as P
from repro_torch.checkpoint import manager as P_CM
from repro_torch.core.lisa.topology import MeshTopology as PTopo
from repro_torch.launch.serve import main as p_main
from repro_torch.serve.cluster import Cluster as PCluster
from repro_torch.serve.engine import Request as PRequest
from repro_torch.weights import params_from_jax

WALL_CLOCK = ("tokens_per_s", "seconds", "decode_compile_count")


@pytest.fixture(scope="module")
def setup():
    cfg = get_reduced("tinyllama-1.1b")
    rparams = R_lm.init_lm(cfg, jax.random.key(0))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    return cfg, rparams, pparams


def _pair(setup, r_faults=None, p_faults=None, **kw):
    cfg, rparams, pparams = setup
    return (ref_cluster(cfg, rparams, faults=r_faults, **kw),
            PCluster(cfg, pparams, faults=p_faults, device="cpu", **kw))


def _drain(cl, uid, prompt, max_new, replica):
    req = (RRequest if isinstance(cl, RCluster) else PRequest)(
        uid=uid, prompt=prompt, max_new=max_new)
    cl.submit(req, replica=replica)
    while cl.active:
        cl.step()
    return req


# ---------------------------------------------------------------------------
# the fault modes and the wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fault", [
    (0, 5, 0x40),                    # NULL: the payload itself
    (1, 5, 0x40), (1, 0, 0xFF), (1, 4095, 1),
    (1, 10_000_000, 0x11),           # clipped to the last byte
    (1, -7, 0x22),                   # clipped to the first
    (2, 1, 0), (2, 0, 0), (2, 99, 0), (2, -3, 0),
    (7, 3, 0x33),                    # no mode holds code 7: unchanged
], ids=lambda f: "-".join(map(str, f)))
def test_fault_modes_bit_equal_to_reference(fault):
    assert PF.FAULT_CODES == RF.FAULT_CODES
    assert PF.fault_kinds() == RF.fault_kinds()
    rng = np.random.default_rng(sum(map(abs, fault)))
    pages = rng.integers(0, 256, (4, 8, 128), dtype=np.uint8)
    want = np.asarray(RF.apply_fault(jnp.asarray(pages),
                                     jnp.asarray(fault, jnp.int32)))
    src = torch.from_numpy(pages.copy())
    got = PF.apply_fault(src, np.asarray(fault, np.int32))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(src.numpy(), pages)       # never in place


@pytest.fixture
def wrapped():
    """The fault wrappers over hop_chain and page_scatter in both
    packages, as a chaos Cluster installs them."""
    for pkg in (RF, PF):
        pkg.install_fault_backends()
    yield
    for pkg in (RF, PF):
        pkg.uninstall_fault_backends()


@pytest.mark.parametrize("fault", [(0, 0, 0), (1, 1234, 0x5A), (2, 1, 0)],
                         ids=["null", "flip", "drop"])
def test_wrapped_route_applies_the_fault_once(wrapped, fault):
    """gather -> hop chain -> scatter with a fault: the hop chain applies it
    (once: the scatter's wrapper sees no ``fault`` left), the destination
    pool equals the reference's, and the source pool is untouched."""
    rng = np.random.default_rng(1)
    pool = rng.integers(0, 256, (2, 8, 8, 128), dtype=np.uint8)
    src_t, dst_t = [1, 4, 6], [0, 2, 5]
    outs = []
    for MV, topo, as_pool, table in (
            (R_MV, RTopo(4), jnp.asarray,
             lambda t: jnp.asarray(t, jnp.int32)),
            (P_MV, PTopo(4), lambda a: torch.from_numpy(a.copy()),
             lambda t: torch.tensor(t, dtype=torch.int32))):
        plan = MV.plan(MV.Transfer(
            MV.Tier("slow", index=0, axis="replica"),
            MV.Tier("slow", index=2, axis="replica"),
            MV.Layout.raw_pages(3, 8, 128, np.uint8)), topo=topo)
        src, dst = as_pool(pool[0]), as_pool(pool[1])
        env = MV.execute(plan, src_pool=src, src_table=table(src_t),
                         dst_pool=dst, dst_table=table(dst_t),
                         local_fabric=True,
                         fault=np.asarray(fault, np.int32))
        assert "fault" not in env
        outs.append((np.asarray(env["dst_pool"]), np.asarray(src)))
    (r_dst, _), (p_dst, p_src) = outs
    assert np.array_equal(p_dst, r_dst)
    assert np.array_equal(p_src, pool[0])
    clean = pool[1].copy()
    clean[dst_t] = pool[0][src_t]
    n_bad = int((p_dst != clean).sum())
    assert n_bad == {0: 0, 1: 1}.get(fault[0], n_bad)
    if fault[0] == 2:
        assert not p_dst[dst_t[1]].any()


def test_corrupted_wave_leaves_the_source_intact(setup):
    """A migration wave that lands corrupt (rate 1, recovery off) changes
    one byte of the destination row and none of the source row; the
    ledger marks the session, and its resume's verify catches it."""
    cfg = setup[0]
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, 7).astype(np.int32)
    spec = dict(rate=1.0, seed=5, recover=False)
    injs = (RF.FaultInjector(RF.FaultSpec(**spec)),
            PF.FaultInjector(PF.FaultSpec(**spec)))
    rc, pc = _pair(setup, *injs, n_replicas=2, slots=2, max_len=48,
                   n_sessions=8)
    for cl in (rc, pc):
        _drain(cl, 3, prompt, 3, replica=0)
    src = pc.replicas[0].sessions.slow[3].clone()
    rc.migrate(3, 1)
    pc.migrate(3, 1)
    assert np.array_equal(pc.replicas[0].sessions.slow[3].numpy(),
                          src.numpy())
    diff = pc.replicas[1].sessions.slow[3].numpy() != src.numpy()
    assert int(diff.sum()) == 1
    assert pc.drain_fault_events() == rc.drain_fault_events()
    assert injs[1].summary() == injs[0].summary()
    assert injs[1].is_corrupt(3)
    assert pc.scrub() == rc.scrub() == 1
    for cl in (rc, pc):
        cl.resume(3, extra_new=2)
        while cl.active:
            cl.step()
    assert pc.verify_failure_count() == rc.verify_failure_count() == 1


def test_migration_retries_match_the_reference(setup):
    """Under a heavy movement-fault rate with recovery armed, both
    packages draw the same faults, retry the same routes and land the same
    bytes; every clean event's row is the source's, bit for bit."""
    cfg = setup[0]
    spec = dict(rate=0.6, seed=3, max_retries=8)
    injs = (RF.FaultInjector(RF.FaultSpec(**spec)),
            PF.FaultInjector(PF.FaultSpec(**spec)))
    rc, pc = _pair(setup, *injs, n_replicas=2, slots=2, max_len=48,
                   n_sessions=8)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, 7).astype(np.int32)
    for cl in (rc, pc):
        _drain(cl, 3, prompt, 3, replica=0)
    src, n_events = 0, 0
    for _ in range(10):
        dst = 1 - src
        want = pc.replicas[src].sessions.slow[3].clone()
        rc.migrate(3, dst)
        pc.migrate(3, dst)
        evs = pc.drain_fault_events()
        assert evs == rc.drain_fault_events()
        for ev in evs:
            n_events += 1
            if ev["corrupt_uid"] is None:
                assert np.array_equal(
                    pc.replicas[dst].sessions.slow[3].numpy(), want.numpy())
            else:
                for inj in injs:
                    inj.consume_corrupt(ev["corrupt_uid"], "detected")
        src = dst
    assert injs[1].summary() == injs[0].summary()
    assert pc.cluster_stats == rc.cluster_stats
    s = injs[1].summary()
    assert s["movement_fired"] >= 1 and n_events >= 1
    assert n_events == s["retry_fixed"] + s["new_corrupt"] + s["merged"]


def test_corrupt_at_rest_is_detected_on_resume(setup):
    cfg = setup[0]
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, 6).astype(np.int32)
    for cl in _pair(setup, RF.FaultInjector(RF.FaultSpec()),
                    PF.FaultInjector(PF.FaultSpec()), n_replicas=2, slots=2,
                    max_len=48, n_sessions=8):
        _drain(cl, 2, prompt, 3, replica=0)
        assert cl.verify_failure_count() == 0
        eng = cl.replicas[0]
        eng.corrupt_stored(2 % eng.n_sessions, page=0, byte=5, xor=0x11)
        assert int(cl.scrub()) == 1
        cl.resume(2, extra_new=2)
        while cl.active:
            cl.step()
        assert cl.verify_failure_count() == 1


# ---------------------------------------------------------------------------
# snapshots and recovery
# ---------------------------------------------------------------------------

def test_failed_replica_restore_matches_reference(setup):
    """drain on replica 0, snapshot, kill replica 0, restore on replica 1:
    the snapshot's bytes are the port's store row, its cost and the
    restored session's tokens are the reference's, and the restored row
    verifies."""
    cfg = setup[0]
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, 9).astype(np.int32)
    toks, costs = [], []
    for cl, F in zip(_pair(setup, n_replicas=2, slots=2, max_len=48,
                           n_sessions=8), (RF, PF)):
        req = _drain(cl, 7, prompt, 4, replica=0)
        snaps, cost = F.snapshot_sessions(cl)
        assert 7 in snaps and cost.bytes > 0
        assert snaps[7].pages.dtype == np.uint8
        assert snaps[7].sums.dtype == np.uint32
        if F is PF:
            assert np.array_equal(snaps[7].pages,
                                  cl.replicas[0].sessions.slow[7].numpy())
            assert np.array_equal(snaps[7].sums.astype(np.int64),
                                  cl.replicas[0].session_sums[7].numpy())
        inflight, suspended = cl.fail_replica(0)
        assert inflight == [] and 7 in suspended
        assert 7 not in cl.session_pos
        assert (cl.replicas[0].sessions.policy.tags < 0).all()
        rcost = F.restore_session(cl, snaps[7], 1)
        assert cl.residence[7] == 1
        slot = cl.resume(7, extra_new=5)
        r2 = cl.active[slot]
        while cl.active:
            cl.step()
        toks.append(req.generated + r2.generated[1:])
        costs.append((tuple(cost), tuple(rcost)))
        assert cl.verify_failure_count() == 0
    assert toks[1] == toks[0]
    assert costs[1] == costs[0]


def test_scheduler_replica_failure_matches_reference(setup):
    """A scheduled mid-run replica death with snapshots on: the restores,
    requeues, ledger, clock, decisions and tokens equal the reference's."""
    cfg = setup[0]
    runs = []
    for pkg, F, Cl, params in ((R, RF, RCluster, setup[1]),
                               (P, PF, PCluster, setup[2])):
        wl = pkg.WorkloadConfig(n_fresh=4, n_followups=6)
        arrivals = pkg.generate_workload(wl, seed=5,
                                         vocab_size=cfg.vocab_size)
        inj = F.FaultInjector(F.FaultSpec(replica_failures=((25, 1),)))
        kw = dict(n_replicas=2, slots=2, max_len=48,
                  n_sessions=pkg.n_sessions_for(wl), faults=inj)
        cl = (ref_cluster(cfg, params, **kw) if pkg is R
              else Cl(cfg, params, device="cpu", **kw))
        tokens = []
        step_end = cl.step_end

        def logged(h, step_end=step_end, tokens=tokens):
            done = step_end(h)
            tokens.extend((r.uid, list(r.generated)) for _, r in done)
            return done
        cl.step_end = logged
        s = pkg.ClusterScheduler(cl, arrivals=arrivals, snapshot_every=8)
        summary = s.run()
        assert summary["jobs_completed"] == len(arrivals)
        runs.append((summary, s.lane_log, tokens, inj.summary(),
                     [dataclasses.astuple(d) for d in s.metrics.decisions],
                     cl.residence, cl.verify_failure_count()))
    assert runs[1] == runs[0]
    f = runs[1][0]["faults"]["counters"]
    assert f["replica_failures"] == 1 and f.get("recovered", 0) >= 1
    assert any(d[1] == "snapshot_wave" for d in runs[1][4])


def test_snapshots_persist_across_packages(tmp_path, setup):
    """A snapshot set the port saves loads in the reference and back, and
    one the reference saves loads in the port, leaf for leaf."""
    cfg = setup[0]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
               for _ in range(2)]
    rc, pc = _pair(setup, n_replicas=2, slots=2, max_len=48, n_sessions=8)
    for cl in (rc, pc):
        for uid, p in zip((1, 5), prompts):
            _drain(cl, uid, p, 3, replica=0)
        cl.fork(1, 6, seed_token=3)
    psnaps, _ = PF.snapshot_sessions(pc)
    rsnaps, _ = RF.snapshot_sessions(rc)
    assert psnaps[6].alias_of == rsnaps[6].alias_of == 1
    PF.save_snapshots(psnaps, str(tmp_path / "port"), step=3)
    RF.save_snapshots(rsnaps, str(tmp_path / "ref"), step=3)
    for snaps, d in ((psnaps, "port"), (rsnaps, "ref")):
        for load in (RF.load_snapshots, PF.load_snapshots):
            back = load(str(tmp_path / d))
            assert sorted(back) == [1, 5, 6]
            for uid, s in snaps.items():
                b = back[uid]
                assert (b.pos, b.tok, b.alias_of) == (s.pos, s.tok,
                                                      s.alias_of)
                for name in ("pages", "sums"):
                    got, want = getattr(b, name), getattr(s, name)
                    assert (got is None) == (want is None)
                    if want is not None:
                        assert got.dtype == want.dtype
                        assert np.array_equal(got, want)
    # the two packages' files hold the same keys, dtypes and shapes
    npz = [np.load(tmp_path / d / "step_00000003" / "arrays.npz")
           for d in ("port", "ref")]
    assert sorted(npz[0].files) == sorted(npz[1].files)
    for k in npz[1].files:
        assert (npz[0][k].dtype, npz[0][k].shape) == \
            (npz[1][k].dtype, npz[1][k].shape)


def test_checkpoints_cross_between_packages(tmp_path):
    """A nested tree the port saves is verified and restored by the
    reference, and the reverse; the staging cost is the reference's."""
    rng = np.random.default_rng(6)
    tree = {"w": rng.standard_normal((8, 8)).astype(np.float32),
            "layers": [rng.integers(0, 9, (3,)).astype(np.int32),
                       rng.integers(0, 256, (2, 4)).astype(np.uint8)],
            "b": np.ones(8, np.float32)}
    ptree = {"w": torch.from_numpy(tree["w"]),
             "layers": [torch.from_numpy(a) for a in tree["layers"]],
             "b": torch.from_numpy(tree["b"])}
    rtree = jax.tree.map(jnp.asarray, tree)
    P_CM.save(ptree, str(tmp_path / "port"), 7)
    R_CM.save(rtree, str(tmp_path / "ref"), 7)
    assert tuple(P_CM.last_move_cost()) == tuple(R_CM.last_move_cost())
    for d in ("port", "ref"):
        assert P_CM.latest_step(str(tmp_path / d)) == 7
        assert R_CM.all_steps(str(tmp_path / d)) == [7]
        R_CM.verify_checkpoint(str(tmp_path / d), 7)
        P_CM.verify_checkpoint(str(tmp_path / d), 7)
        rb = R_CM.restore(rtree, str(tmp_path / d))
        pb = P_CM.restore(ptree, str(tmp_path / d), device="cpu")
        assert isinstance(pb["layers"], list)
        for a, b, c in zip(jax.tree.leaves(tree), jax.tree.leaves(rb),
                           [pb["b"], *pb["layers"], pb["w"]]):
            assert np.array_equal(np.asarray(b), a)
            assert c.numpy().dtype == a.dtype and np.array_equal(c.numpy(), a)
    assert tuple(P_CM.last_move_cost()) == tuple(R_CM.last_move_cost())


@pytest.mark.parametrize("damage", ["truncated", "flipped"])
def test_corrupt_checkpoint_is_refused(tmp_path, damage):
    tree = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.ones(8)}
    P_CM.save(tree, str(tmp_path), 1)
    npz = tmp_path / "step_00000001" / "arrays.npz"
    raw = bytearray(npz.read_bytes())
    if damage == "truncated":
        raw = raw[: len(raw) // 2]
        match = "truncated"
    else:
        raw[len(raw) // 2] ^= 0xFF
        match = "crc"
    npz.write_bytes(bytes(raw))
    for restore in (lambda: P_CM.restore(tree, str(tmp_path), device="cpu"),
                    lambda: PF.load_snapshots(str(tmp_path)),
                    lambda: R_CM.verify_checkpoint(str(tmp_path), 1)):
        with pytest.raises((P_CM.CorruptCheckpoint, R_CM.CorruptCheckpoint),
                           match=match):
            restore()
    P_CM.save(tree, str(tmp_path), 2)
    back = P_CM.restore(tree, str(tmp_path), step=2, device="cpu")
    assert torch.equal(back["w"], tree["w"])
    assert not [d for d in tmp_path.iterdir() if d.name.startswith(".tmp")]


def test_checkpoint_gc_and_missing_dir(tmp_path):
    tree = {"x": torch.zeros(3), "step": 4}
    for s in (1, 2, 3, 4, 5):
        P_CM.save(tree, str(tmp_path), s, keep_last=2)
    assert P_CM.all_steps(str(tmp_path)) == [4, 5]
    assert int(P_CM.restore(tree, str(tmp_path), device="cpu")["step"]) == 4
    with pytest.raises(FileNotFoundError):
        P_CM.restore(tree, str(tmp_path / "nope"), device="cpu")


# ---------------------------------------------------------------------------
# the chaos launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chaos", [["0.25", "7"], ["0.1", "3"],
                                   ["0.25", "7", "--no-recovery"]],
                         ids=["rate0.25-seed7", "rate0.1-seed3",
                              "no-recovery"])
def test_chaos_launcher_json_matches_reference(chaos):
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--replicas", "2",
            "--slots", "2", "--requests", "4", "--followups", "6",
            "--fault-rate", chaos[0], "--fault-seed", chaos[1]] + chaos[2:]
    want = r_main(argv)
    got = p_main(argv + ["--device", "cpu"])
    assert ({k: v for k, v in got.items() if k not in WALL_CLOCK}
            == {k: v for k, v in want.items() if k not in WALL_CLOCK})
    led = got["fault_ledger"]
    assert got["jobs_completed"] == 10
    assert led["new_corrupt"] == (led["detected"] + led["recovered"]
                                  + led["destroyed"]
                                  + led["at_rest_corrupt"])
    assert got["verify_failed"] == led["detected"]
    assert got["at_rest_corrupt"] == led["at_rest_corrupt"]
    if "--no-recovery" in chaos:
        assert led["recovered"] == led["retries"] == 0


def test_degraded_fast_tier_reroutes_pricing(setup):
    for cl in _pair(setup, n_replicas=2, slots=2, max_len=48, n_sessions=8):
        cl.degrade_fast(1)
        assert cl.replicas[1].fast_degraded
        assert not cl.replicas[1].fast_resident_uids()
        assert (np.asarray(cl.replicas[1].sessions.policy.tags) < 0).all()
