"""The reference's migration and cross-replica fork plans
(``tests/test_cluster.py:343-381``, ``tests/test_fork.py:551-589``) executed
by the port over a mesh axis: page gather -> hop chain (``rbm.lisa_copy``
over ``env["axes"][leg.axis]``) -> page scatter.

They run on ``StackedAxis(4, device="cpu")`` and on a ``GroupAxis`` over 4
gloo ranks, and land bit-exactly as the numpy oracle those tests write
(``want[DST][dst_table] = want[SRC][src_table]``); every other replica's
pool keeps every byte.  The reference's own mesh runs of these plans fail
on this tree (ROADMAP Queue 3), so they are no baseline; the plans
themselves equal the reference's, leg for leg and in cost.
"""
import numpy as np
import pytest
import torch

from _torch_ranks import run_gloo, run_stacked
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro import movement as R_MV
from repro.core.lisa.topology import MeshTopology as R_Topo
from repro_torch import movement as P_MV
from repro_torch.core.lisa.topology import MeshTopology as P_Topo
from repro_torch.launch.mesh import StackedAxis

N = 4
# (name, plan kind, src replica, dst replica), as mesh_movement_job runs
PLANS = [("migration", "move", 0, 2), ("fork", "fork", 1, 3)]


def _inputs():
    rng = np.random.default_rng(3)
    local = {"pool": rng.integers(0, 256, (N, 8, 8, 128)).astype(np.uint8)}
    shared = {"migration_src": np.asarray([1, 4, 6], np.int32),
              "migration_dst": np.asarray([0, 2, 5], np.int32),
              "fork_src": np.asarray([2, 3], np.int32),
              "fork_dst": np.asarray([5, 6], np.int32)}
    return local, shared


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    local, shared = _inputs()
    gloo = run_gloo(["mesh_movement"], N, local, shared,
                    tmp_path_factory.mktemp("mesh"))["mesh_movement"]
    return {"stacked": run_stacked("mesh_movement", N, local, shared),
            "gloo": gloo, "local": local, "shared": shared}


def _plan(mv, topo, kind, src, dst, n_pages):
    return mv.plan(mv.Transfer(mv.Tier("slow", index=src, axis="replica"),
                               mv.Tier("slow", index=dst, axis="replica"),
                               mv.Layout.raw_pages(n_pages, 8, 128,
                                                   np.uint8), kind=kind),
                   topo=topo(N))


@pytest.mark.parametrize("name,kind,src,dst", PLANS)
@pytest.mark.parametrize("run", ["stacked", "gloo"])
def test_plan_lands_bit_exactly(runs, run, name, kind, src, dst):
    want = runs["local"]["pool"].copy()
    st, dt = runs["shared"][f"{name}_src"], runs["shared"][f"{name}_dst"]
    want[dst][dt] = want[src][st]
    got = runs[run][name]
    assert got.shape == want.shape
    assert np.array_equal(got, want), f"{name} did not land bit-exactly"


@pytest.mark.parametrize("name,kind,src,dst", PLANS)
@pytest.mark.parametrize("run", ["stacked", "gloo"])
def test_hop_chain_takes_the_priced_route(runs, run, name, kind, src, dst):
    """The executed chain is the priced one: as many hops as the plan's
    leg (the shorter way round the ring)."""
    hops = _plan(P_MV, P_Topo, kind, src, dst, 2).legs[1].hops
    assert hops == 2
    assert runs[run][f"{name}_hops"].tolist() == [[hops]] * N


@pytest.mark.parametrize("name,kind,src,dst", PLANS)
def test_plan_equals_the_reference(name, kind, src, dst):
    n_pages = 3 if name == "migration" else 2
    rp = _plan(R_MV, R_Topo, kind, src, dst, n_pages)
    pp = _plan(P_MV, P_Topo, kind, src, dst, n_pages)
    assert [l.kind for l in pp.legs] == [l.kind for l in rp.legs] == \
        ["page_gather", "hop_chain", "page_scatter"]
    for a, b in zip(pp.legs, rp.legs):
        assert (a.hops, a.nbytes) == (b.hops, b.nbytes)
    assert tuple(pp.cost) == tuple(rp.cost)


def test_missing_axis_name_raises():
    """A hop_chain leg whose axis the env does not name raises, whether
    the env names other axes or none; local_fabric stays the identity."""
    local, shared = _inputs()
    plan = _plan(P_MV, P_Topo, "move", 0, 2, 3)
    pool = torch.from_numpy(local["pool"].copy())
    ax = StackedAxis(N, device="cpu", name="data")
    kw = dict(src_pool=pool, src_table=shared["migration_src"],
              dst_pool=pool, dst_table=shared["migration_dst"])
    with pytest.raises(KeyError, match="replica"):
        P_MV.execute(plan, axes={"data": ax}, **kw)
    hop_only = P_MV.MovementPlan(plan.transfer, plan.legs[1:2], plan.cost)
    with pytest.raises(KeyError, match="replica"):
        P_MV.execute(hop_only, data=pool)
    assert P_MV.execute(hop_only, data=pool,
                        local_fabric=True)["data"] is pool


def test_mesh_page_legs_stay_in_their_device_pool():
    """In a mesh env the page legs take (local, P, ...) pools: one launch
    over the stack, each device's entries offset into its own pool.  A
    host table entry outside [0, P) raises; a per-device (local, T) table
    reads each device's own rows, and a -1 entry zeros."""
    local, _ = _inputs()
    pool = torch.from_numpy(local["pool"].copy())
    ax = StackedAxis(N, device="cpu", name="replica")
    gather = P_MV.PageGatherLeg(nbytes=0)
    run = P_MV.get_backend("page_gather")
    with pytest.raises(IndexError):
        run(gather, {"pool": pool, "table": [8], "axes": {"replica": ax}})
    table = torch.tensor([[0, 7], [1, 6], [2, 5], [3, -1]],
                         dtype=torch.int32)
    got = run(gather, {"pool": pool, "table": table,
                       "axes": {"replica": ax}})["data"]
    for d in range(N):
        for j in range(2):
            e = int(table[d, j])
            assert torch.equal(got[d, j], pool[d, e] if e >= 0
                               else torch.zeros_like(pool[d, 0]))
