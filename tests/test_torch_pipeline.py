"""The port's GPipe (``train/pipeline.py``) against the reference's, at its
test's shapes: 4 stages x 2 layers of ``tanh(x @ w + b)`` at D 16, 6
microbatches of 3 rows.

The reference runs once, in a subprocess with 4 forced host devices; the
port runs the same numpy inputs on ``StackedAxis(4, device="cpu")`` and on
a ``GroupAxis`` over 4 gloo ranks, each within 1e-5 of the reference's
pipelined output and of the sequential run.  The stage hop is the
reference's planned movement: one shift-mode ``hop_chain`` leg, executed
once a slot.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from _multidev import run_with_devices
from _torch_ranks import run_gloo, run_stacked
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro import movement as R_MV
from repro_torch import movement as P_MV

N_STAGES, D, L_PER, N_MICRO, MB = 4, 16, 2, 6, 3
BAR = 1e-5

REF = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.train.pipeline import pipeline_transformer

mesh = jax.make_mesh((4,), ("pp",))
z = np.load({path!r})

def layer_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])

run = jax.jit(pipeline_transformer(mesh, "pp", layer_fn, {l_per}))
got = run({{"w": z["w"], "b": z["b"]}}, z["micro"])
np.save({out!r}, np.asarray(got))
print("PIPE_OK")
"""


def _inputs():
    rng = np.random.default_rng(11)
    return {"w": rng.standard_normal((N_STAGES, L_PER, D, D),
                                     np.float32) * np.float32(0.3),
            "b": rng.standard_normal((N_STAGES, L_PER, D),
                                     np.float32) * np.float32(0.1),
            "micro": rng.standard_normal((N_MICRO, MB, D), np.float32)}


def _sequential(z):
    h = z["micro"]
    for s in range(N_STAGES):
        for i in range(L_PER):
            h = np.tanh(h @ z["w"][s, i] + z["b"][s, i])
    return h


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    z = _inputs()
    np.savez(tmp / "in.npz", **z)
    local = {"w": z["w"], "b": z["b"],
             "micro": np.broadcast_to(z["micro"], (N_STAGES,)
                                      + z["micro"].shape).copy()}
    shared = {"l_per": np.asarray(L_PER)}
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_with_devices, REF.format(
            path=str(tmp / "in.npz"), out=str(tmp / "ref.npy"),
            l_per=L_PER), N_STAGES)
        gloo_dir = tmp / "gloo"
        gloo_dir.mkdir()
        gloo = run_gloo(["pipeline"], N_STAGES, local, shared,
                        gloo_dir)["pipeline"]
        stacked = run_stacked("pipeline", N_STAGES, local, shared)
        assert "PIPE_OK" in ref.result()
    return {"ref": np.load(tmp / "ref.npy"), "seq": _sequential(z),
            "stacked": stacked, "gloo": gloo}


@pytest.mark.parametrize("run", ["stacked", "gloo"])
def test_gpipe_matches_reference(runs, run):
    """Every stage returns all the outputs (the closing psum), each within
    1e-5 of the reference's pipelined run and of the sequential one."""
    got = runs[run]["out"]
    assert got.shape == (N_STAGES, N_MICRO, MB, D)
    np.testing.assert_allclose(runs["ref"], runs["seq"], atol=BAR)
    for stage in range(N_STAGES):
        np.testing.assert_allclose(got[stage], runs["ref"], atol=BAR)
        np.testing.assert_allclose(got[stage], runs["seq"], atol=BAR)


@pytest.mark.parametrize("run", ["stacked", "gloo"])
def test_gpipe_schedule_is_one_hop_a_slot(runs, run):
    """n_stages + n_micro - 1 slots, one stage hop each (the hop_chain leg
    over the axis), and one reduction: the closing psum."""
    slots = N_STAGES + N_MICRO - 1
    assert runs[run]["slots"].tolist() == [[slots]] * N_STAGES
    assert runs[run]["counts"].tolist() == [[slots, 1]] * N_STAGES


def test_stage_hop_plan_equals_the_reference():
    """The stage -> stage transfer lowers to the reference's plan: one
    shift-mode hop_chain leg, priced the same."""
    def plan(mv):
        return mv.plan(mv.Transfer(mv.Tier("stage", axis="pp"),
                                   mv.Tier("stage", axis="pp"),
                                   mv.Layout.dense((MB, D), np.float32)))
    rp, pp = plan(R_MV), plan(P_MV)
    assert [l.kind for l in pp.legs] == [l.kind for l in rp.legs] \
        == ["hop_chain"]
    leg = pp.legs[0]
    assert (leg.axis, leg.src, leg.dst, leg.step, leg.hops) == \
        ("pp", None, None, 1, 1)
    assert tuple(pp.cost) == tuple(rp.cost)
