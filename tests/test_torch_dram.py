"""The port's DRAM evaluation against the reference: VILLA's split policy,
the functional substrate, the controller simulator and the traces.

Bars: the split policy, the substrate's states and VILLA's hits and
accesses are integer or byte data and must be bit-equal; Table 1's
latencies and energies are the spec's Python floats and must be equal.
The controller's floats (core stall, energy, mean latency, hit rate) come
from the same f32 operations in the same order and agree to f32 rounding:
the bar is rtol 1e-6 (on these traces they are bit-equal but for the mean
latency, whose sum is ordered differently, ~1e-7 apart).  The port's trace
generator draws with torch's samplers, not jax.random's, so it is held to
the reference's properties, not its draws; parity runs hand the
reference's traces across with ``trace_from_numpy``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro.core.dram import controller as RC
from repro.core.dram import substrate as RS
from repro.core.dram import traces as RT
from repro.core.dram import villa as RV
from repro.core.dram.spec import DDR3_1600 as R_DDR3
from repro_torch.core.dram import controller as PC
from repro_torch.core.dram import substrate as PS
from repro_torch.core.dram import traces as PT
from repro_torch.core.dram import villa as PV
from repro_torch.core.dram.spec import DDR3_1600 as P_DDR3

FIELDS = ("cells", "row_buffer", "rb_valid", "open_row")
FLOAT_BAR = 1e-6
CONFIGS = {      # tests/test_dram_controller.py's seven
    "base": dict(copy_mech="memcpy"),
    "rc": dict(copy_mech="rc_intersa"),
    "lisa": dict(copy_mech="lisa"),
    "villa": dict(copy_mech="lisa", use_villa=True),
    "comb": dict(copy_mech="lisa", use_villa=True, use_lip=True),
    "lip": dict(copy_mech="memcpy", use_lip=True),
    "rc_villa": dict(copy_mech="memcpy", use_villa=True,
                     villa_copy_mech="rc_intersa"),
}


# ---------------------------------------------------------------- villa ---

def _villa_cfgs(**kw):
    return RV.VillaConfig(**kw), PV.VillaConfig(**kw)


def test_argmin_takes_the_first_minimum():
    """The victim is the first minimum-benefit slot in both frameworks."""
    x = [3, 1, 4, 1, 1, 2]
    assert int(jnp.argmin(jnp.asarray(x))) == 1
    assert int(torch.argmin(torch.tensor(x, dtype=torch.int32))) == 1
    lanes = torch.tensor([[2, 0, 0], [5, 5, 5]], dtype=torch.int32)
    assert torch.argmin(lanes, dim=-1).tolist() == [1, 0]


@pytest.mark.parametrize("n,n_banks,kw", [
    # several epochs a bank, few counters: ties in the top-k and rows
    # that alias one counter
    (4096, 4, dict(n_counters=64, n_hot=4, epoch_len=128)),
    # the defaults at the controller's shape (8 banks, 256-access epochs)
    (8192, 8, {}),
])
def test_hot_for_sequence_bit_equal(n, n_banks, kw):
    rng = np.random.default_rng(n)
    bank = rng.integers(0, n_banks, n).astype(np.int32)
    row = np.where(rng.random(n) < 0.7, rng.integers(0, 24, n),
                   rng.integers(0, 5000, n)).astype(np.int32)
    rc, pc = _villa_cfgs(**kw)
    want = np.asarray(RV.hot_for_sequence(jnp.asarray(bank),
                                          jnp.asarray(row), n_banks, rc))
    got = PV.hot_for_sequence(torch.from_numpy(bank), torch.from_numpy(row),
                              n_banks, pc).numpy()
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got, want)


def test_hot_for_sequence_saturates_like_the_reference():
    """One bank, epochs of 40,000 accesses, 90% of them to one counter:
    it saturates at 32767 in each epoch, and the halving and the
    threshold at max(k-th, 1) run at the saturated value."""
    n, epoch = 90_000, 40_000
    rng = np.random.default_rng(3)
    row = np.where(rng.random(n) < 0.9, 5,
                   rng.integers(0, 3000, n)).astype(np.int32)
    bank = np.zeros(n, np.int32)
    rc, pc = _villa_cfgs(epoch_len=epoch)
    want = np.asarray(RV.hot_for_sequence(jnp.asarray(bank),
                                          jnp.asarray(row), 1, rc))
    got = PV.hot_for_sequence(torch.from_numpy(bank), torch.from_numpy(row),
                              1, pc).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[row == 5][epoch:].all()            # hot after epoch 1


def test_hot_for_sequence_takes_independent_sequences():
    """A leading axis holds independent sequences (the controller's
    workloads): each row equals its own call."""
    rng = np.random.default_rng(4)
    bank = torch.from_numpy(rng.integers(0, 4, (3, 2048)).astype(np.int32))
    row = torch.from_numpy(rng.integers(0, 40, (3, 2048)).astype(np.int32))
    cfg = PV.VillaConfig(n_counters=32, n_hot=4, epoch_len=64)
    both = PV.hot_for_sequence(bank, row, 4, cfg)
    for w in range(3):
        assert torch.equal(both[w],
                           PV.hot_for_sequence(bank[w], row[w], 4, cfg))


def test_tags_access_sequence_bit_equal():
    """A stream of accesses with seeded hotness through both tags_access:
    tags, benefit, hit and insert equal at every step.  The slots start at
    benefit 0 (ties: the first is the victim) and hits make new ties."""
    rng = np.random.default_rng(5)
    S = 6
    r_tags = jnp.full((S,), -1, jnp.int32)
    r_ben = jnp.zeros((S,), jnp.int32)
    p_tags = torch.full((S,), -1, dtype=torch.int32)
    p_ben = torch.zeros((S,), dtype=torch.int32)
    hits = inserts = 0
    for _ in range(400):
        row = int(rng.integers(0, 12))
        hot = bool(rng.random() < 0.5)
        r_tags, r_ben, r_hit, r_ins = RV.tags_access(
            r_tags, r_ben, jnp.int32(row), jnp.asarray(hot))
        p_tags, p_ben, p_hit, p_ins = PV.tags_access(
            p_tags, p_ben, torch.tensor(row), torch.tensor(hot))
        np.testing.assert_array_equal(p_tags.numpy(), np.asarray(r_tags))
        np.testing.assert_array_equal(p_ben.numpy(), np.asarray(r_ben))
        assert (bool(p_hit), bool(p_ins)) == (bool(r_hit), bool(r_ins))
        hits += bool(p_hit)
        inserts += bool(p_ins)
    assert hits > 50 and inserts > 50


def test_tags_access_over_lanes():
    """Lanes (a leading axis) step independently, each as its own call."""
    rng = np.random.default_rng(6)
    tags = torch.from_numpy(rng.integers(-1, 5, (4, 3, 8)).astype(np.int32))
    ben = torch.from_numpy(rng.integers(0, 3, (4, 3, 8)).astype(np.int32))
    row = torch.from_numpy(rng.integers(0, 5, (4, 3)).astype(np.int32))
    hot = torch.from_numpy(rng.random((4, 3)) < 0.5)
    got = PV.tags_access(tags, ben, row, hot)
    for i in range(4):
        for j in range(3):
            one = PV.tags_access(tags[i, j], ben[i, j], row[i, j],
                                 hot[i, j])
            for a, b in zip(got, one):
                assert torch.equal(a[i, j], b)


# ------------------------------------------------------------ substrate ---

SMALL = R_DDR3.with_geometry(16, 8, 256)
P_SMALL = P_DDR3.with_geometry(16, 8, 256)


@pytest.fixture(scope="module")
def banks():
    """The reference's random bank (``make_bank(key=)``) and the port's
    bank of the same cells."""
    rb = RS.make_bank(SMALL, key=jax.random.key(7))
    pb = PS.BankState(*(torch.from_numpy(np.array(getattr(rb, f)))
                        for f in FIELDS))
    return rb, pb


def _same_state(pb, rb):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(pb, f).numpy(),
                                      np.asarray(getattr(rb, f)), err_msg=f)


def _snapshot(pb):
    return [getattr(pb, f).clone() for f in FIELDS]


def _unchanged(pb, snap):
    assert all(torch.equal(getattr(pb, f), s) for f, s in zip(FIELDS, snap))


def test_make_bank_geometry_and_zeroes():
    pb = PS.make_bank(P_SMALL, device="cpu")
    rb = RS.make_bank(SMALL)
    _same_state(pb, rb)
    rand = PS.make_bank(P_SMALL, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert rand.cells.shape == (16, 8, 256) and rand.cells.dtype == torch.uint8
    assert (rand.n_subarrays, rand.rows_per_subarray, rand.row_bytes) == (
        16, 8, 256)
    assert int(rand.cells.max()) > 200


def test_commands_bit_equal_and_functional(banks):
    """Every command, and the preconditions' masks: an activate, a
    restore-mode activate after an RBM, RBMs that succeed and misfire
    (not adjacent, invalid source, open destination), precharge, column
    read and write (into an open and into a precharged subarray)."""
    rb, pb = banks
    snap = _snapshot(pb)
    steps = [
        ("activate", (3, 2)), ("rbm", (3, 4)), ("activate", (4, 6)),
        ("rbm", (4, 6)),                  # misfire: not adjacent
        ("precharge", (4,)), ("rbm", (3, 4)), ("precharge", (3,)),
        ("rbm", (3, 2)),                  # misfire: source invalid
        ("activate", (5, 1)), ("rbm", (4, 5)),   # misfire: destination open
        ("write_line", (5, 3)), ("write_line", (7, 2)),   # 7 is precharged
        ("activate", (4, 7)), ("precharge", (5,)),
    ]
    rng = np.random.default_rng(8)
    r, p = rb, pb
    for name, args in steps:
        if name == "write_line":
            data = rng.integers(0, 256, 64).astype(np.uint8)
            r = RS.write_line(r, *args, jnp.asarray(data), SMALL)
            p_new = PS.write_line(p, *args, torch.from_numpy(data), P_SMALL)
        else:
            r = getattr(RS, name)(r, *args)
            p_new = getattr(PS, name)(p, *args)
        keep = _snapshot(p)
        _same_state(p_new, r)
        _unchanged(p, keep)
        p = p_new
        for sa in (3, 4, 5):
            for line in (0, 2, 99):       # 99 clamps into the row
                np.testing.assert_array_equal(
                    PS.read_line(p, sa, line, P_SMALL).numpy(),
                    np.asarray(RS.read_line(r, sa, line, SMALL)))
    assert not bool(p.rb_valid[2])        # the misfires invalidated
    _unchanged(pb, snap)


@pytest.mark.parametrize("mech,args", [
    ("lisa", (0, 1, 1, 2)), ("lisa", (0, 1, 7, 2)), ("lisa", (0, 1, 15, 2)),
    ("lisa", (12, 3, 2, 6)), ("rc_intersa", (0, 1, 7, 2)),
    ("rc_bank", (0, 1, 7, 2)), ("memcpy", (5, 4, 2, 0)),
    ("rc_intrasa", (6, 1, 6, 5)),
])
def test_execute_copy_bit_equal(banks, mech, args):
    rb, pb = banks
    snap = _snapshot(pb)
    want = RS.execute_copy(rb, mech, *args, spec=SMALL)
    got = PS.execute_copy(pb, mech, *args, spec=P_SMALL)
    _same_state(got.state, want.state)
    assert (got.latency_ns, got.energy_uj) == (want.latency_ns,
                                               want.energy_uj)
    ssa, srow, dsa, drow = args
    assert torch.equal(got.state.cells[dsa, drow], pb.cells[ssa, srow])
    _unchanged(pb, snap)


def test_broadcast_bit_equal(banks):
    rb, pb = banks
    snap = _snapshot(pb)
    for src, dsts in ((5, (2, 9, 14)), (0, (15,)), (8, (7, 9))):
        want = RS.lisa_broadcast(rb, src, 3, dsts, 6, SMALL)
        got = PS.lisa_broadcast(pb, src, 3, dsts, 6, P_SMALL)
        _same_state(got.state, want.state)
        assert (got.latency_ns, got.energy_uj) == (want.latency_ns,
                                                   want.energy_uj)
    _unchanged(pb, snap)


def test_table1_costs_at_full_geometry():
    """Table 1 through execute_copy on a full-geometry DDR3_1600 bank
    (bench_table1's copies): each destination row bit-equal to its source
    and every cost the spec's table1() — LISA-RISC-1/7/15 at 148.5 /
    196.5 / 260.5 ns, RC-InterSA at 1363.75 ns."""
    bank = PS.make_bank(P_DDR3, generator=torch.Generator().manual_seed(1),
                        device="cpu")
    copies = {"memcpy": ("memcpy", 0, 1, 7, 2),
              "RC-InterSA": ("rc_intersa", 0, 1, 7, 2),
              "RC-Bank": ("rc_bank", 0, 1, 7, 2),
              "RC-IntraSA": ("rc_intrasa", 0, 1, 0, 2),
              "LISA-RISC-1": ("lisa", 0, 1, 1, 2),
              "LISA-RISC-7": ("lisa", 0, 1, 7, 2),
              "LISA-RISC-15": ("lisa", 0, 1, 15, 2)}
    table = P_DDR3.table1()
    assert table == R_DDR3.table1()
    for row, (mech, ssa, srow, dsa, drow) in copies.items():
        res = PS.execute_copy(bank, mech, ssa, srow, dsa, drow, spec=P_DDR3)
        assert torch.equal(res.state.cells[dsa, drow], bank.cells[ssa, srow])
        assert (res.latency_ns, res.energy_uj) == table[row]
    assert [table[k][0] for k in ("LISA-RISC-1", "LISA-RISC-7",
                                  "LISA-RISC-15", "RC-InterSA")] == [
        148.5, 196.5, 260.5, 1363.75]


def test_copy_errors_match(banks):
    rb, pb = banks
    cases = [("nosuch", (0, 1, 2, 3)), ("lisa", (3, 1, 3, 2)),
             ("rc_intrasa", (1, 1, 2, 2)), ("memcpy", (4, 0, 4, 1))]
    for mech, args in cases:
        with pytest.raises(ValueError) as want:
            RS.execute_copy(rb, mech, *args, spec=SMALL)
        with pytest.raises(ValueError) as got:
            PS.execute_copy(pb, mech, *args, spec=P_SMALL)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="must differ"):
        PS.lisa_risc_copy(pb, 2, 0, 2, 1, P_SMALL)
    with pytest.raises(ValueError, match="equals source"):
        PS.lisa_broadcast(pb, 2, 0, (2, 4), 1, P_SMALL)


# ----------------------------------------------------------- controller ---

@pytest.fixture(scope="module")
def shared_trace():
    tcfg = RT.TraceConfig(n_requests=2048)
    tr = RT.generate(jax.random.key(1), tcfg)
    return tcfg, tr, PT.trace_from_numpy(jax.tree.map(np.asarray, tr),
                                         device="cpu")


@pytest.fixture(scope="module")
def grid_on_shared(shared_trace):
    tcfg, _, ptr = shared_trace
    mcfgs = [PC.MechanismConfig(**kw) for kw in CONFIGS.values()]
    return PC.simulate_grid(PC.stack_traces([ptr]),
                            PT.TraceConfig(n_requests=2048), mcfgs)


def test_controller_matches_the_reference(shared_trace, grid_on_shared):
    """The reference's trace under all seven configs in one grid: VILLA's
    hits and accesses exact, the floats within FLOAT_BAR."""
    tcfg, tr, _ = shared_trace
    for i, kw in enumerate(CONFIGS.values()):
        want = RC.simulate(tr, tcfg, RC.MechanismConfig(**kw))
        acc = int(grid_on_shared["villa_accesses"][i, 0])
        hits = int(grid_on_shared["villa_hits"][i, 0])
        assert acc == (2048 if kw.get("use_villa") else 0)
        assert hits == round(float(want["villa_hit_rate"]) * acc)
        for key in ("core_stall", "energy_uJ", "avg_latency_ns",
                    "villa_hit_rate"):
            np.testing.assert_allclose(
                grid_on_shared[key][i, 0].numpy(), np.asarray(want[key]),
                rtol=FLOAT_BAR, atol=0, err_msg=f"{kw} {key}")
    assert int(grid_on_shared["villa_hits"][3, 0]) > 0


def test_simulate_sweep_and_grid_agree(shared_trace, grid_on_shared):
    """One lane (simulate), one lane a workload (simulate_sweep) and one
    lane a (config, workload) pair (simulate_grid) give the same numbers."""
    _, _, ptr = shared_trace
    tcfg = PT.TraceConfig(n_requests=2048)
    two = PC.stack_traces([ptr, ptr])
    for i, kw in enumerate(CONFIGS.values()):
        mcfg = PC.MechanismConfig(**kw)
        one = PC.simulate(ptr, tcfg, mcfg)
        sweep = PC.simulate_sweep(two, tcfg, mcfg) if i in (0, 3) else None
        for key, v in one.items():
            assert torch.equal(v, grid_on_shared[key][i, 0]), (kw, key)
            if sweep is not None:
                assert torch.equal(sweep[key][1], v), (kw, key)
    assert PC.simulate_jit is PC.simulate
    with pytest.raises(ValueError, match="shared VillaConfig"):
        PC.simulate_grid(two, tcfg, [
            PC.MechanismConfig(), PC.MechanismConfig(
                villa=PV.VillaConfig(n_slots=8))])


@pytest.fixture(scope="module")
def port_results():
    """tests/test_dram_controller.py's setup on the port's own trace."""
    tcfg = PT.TraceConfig(n_requests=8192)
    tr = PT.generate(torch.Generator().manual_seed(1), tcfg, device="cpu")
    mcfgs = [PC.MechanismConfig(**kw) for kw in CONFIGS.values()]
    g = PC.simulate_grid(PC.stack_traces([tr]), tcfg, mcfgs)
    out = {name: {k: v[i, 0] for k, v in g.items()}
           for i, name in enumerate(CONFIGS)}
    ws = {k: float(PC.weighted_speedup(out["base"]["core_stall"],
                                       r["core_stall"]))
          for k, r in out.items()}
    return out, ws


def test_port_keeps_the_paper_orderings(port_results):
    out, ws = port_results
    assert ws["lisa"] > ws["rc"] > ws["base"] == pytest.approx(1.0)
    assert ws["villa"] > ws["lisa"]
    assert ws["comb"] > ws["villa"]
    assert 1.0 < ws["lip"] < 1.5
    assert ws["rc_villa"] < 1.0
    red = 1 - float(out["comb"]["energy_uJ"]) / float(
        out["base"]["energy_uJ"])
    assert red > 0.3
    assert float(out["villa"]["villa_hit_rate"]) > 0.3


def test_port_sweep_orderings_hold():
    """test_workload_sweep_orderings_hold's corners, as one sweep each."""
    for copy_prob, zipf in [(0.002, 1.0), (0.02, 1.6)]:
        tcfg = PT.TraceConfig(n_requests=4096, copy_prob=copy_prob,
                              zipf_s=zipf)
        tr = PT.generate_batch([torch.Generator().manual_seed(7)],
                               [copy_prob], [zipf], tcfg, device="cpu")
        g = PC.simulate_grid(tr, tcfg, [
            PC.MechanismConfig("memcpy"), PC.MechanismConfig("lisa"),
            PC.MechanismConfig("lisa", use_villa=True, use_lip=True)])
        ws_l = float(PC.weighted_speedup(g["core_stall"][0, 0],
                                         g["core_stall"][1, 0]))
        ws_c = float(PC.weighted_speedup(g["core_stall"][0, 0],
                                         g["core_stall"][2, 0]))
        assert ws_l > 1.0
        assert ws_c > ws_l * 0.95


# --------------------------------------------------------------- traces ---

def test_trace_properties():
    tcfg = PT.TraceConfig(n_requests=20_000, copy_prob=0.02)
    tr = PT.generate(torch.Generator().manual_seed(11), tcfg, device="cpu")
    spec = P_DDR3
    rps, n_rows = spec.rows_per_subarray, spec.n_rows
    assert bool((tr.t[1:] >= tr.t[:-1]).all()) and tr.t.dtype == torch.float32
    for name in ("row", "dst_row"):
        x = getattr(tr, name)
        assert x.dtype == torch.int32
        assert int(x.min()) >= rps and int(x.max()) < n_rows
    assert int(tr.core.max()) < tcfg.n_cores and int(tr.bank.max()) < 8
    copies = tr.is_copy
    assert bool(((tr.dst_row[copies] // rps) != (tr.row[copies] // rps))
                .all())
    # 80% from the hot set, plus the uniform tail's share of it
    hot = float((tr.row < rps + tcfg.hot_rows).float().mean())
    assert abs(hot - 0.8) <= 0.03
    n, p = tcfg.n_requests, tcfg.copy_prob
    share = float(copies.float().mean())
    assert abs(share - p) <= 3 * (p * (1 - p) / n) ** 0.5
    again = PT.generate(torch.Generator().manual_seed(11), tcfg,
                        device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tr, again))


def test_generate_batch_stacks_generate():
    tcfg = PT.TraceConfig(n_requests=512)
    probs, zipfs = [0.01, 0.04], [1.0, 1.8]
    batch = PT.generate_batch([torch.Generator().manual_seed(s)
                               for s in (1, 2)], probs, zipfs, tcfg,
                              device="cpu")
    for w, s in enumerate((1, 2)):
        one = PT.generate(torch.Generator().manual_seed(s), dataclasses.replace(
            tcfg, copy_prob=probs[w], zipf_s=zipfs[w]), device="cpu")
        assert all(torch.equal(a[w], b) for a, b in zip(batch, one))


def test_trace_from_numpy_round_trip(shared_trace):
    _, tr, ptr = shared_trace
    for f in PT.Trace._fields:
        np.testing.assert_array_equal(getattr(ptr, f).numpy(),
                                      np.asarray(getattr(tr, f)))
    assert ptr.is_copy.dtype == torch.bool and ptr.t.dtype == torch.float32


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PT.generate(torch.Generator(), PT.TraceConfig(n_requests=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PS.make_bank(P_SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PC.mechanism_params(PC.MechanismConfig())
