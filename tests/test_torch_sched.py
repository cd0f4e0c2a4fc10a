"""The port's Scheduler against the reference's on the same weights and the
same arrival stream: the BENCH_sched arms (fifo and cost_aware on the
seed-4 bursty Zipf stream of 36 jobs, 4 slots, max_len 96), the bank
contention model, and a traced run.  Decisions, the virtual clock and every
summary number are host arithmetic over token counts, so they must be
identical; the tokens themselves come from shared weights and must be
equal too."""
import dataclasses

import jax
import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro import sched as R
from repro.configs import get_reduced
from repro.models import lm as R_lm
from repro.obs import Tracer as RTracer
from repro.serve.engine import Engine as REngine
from repro_torch import sched as P
from repro_torch.obs import Tracer as PTracer
from repro_torch.serve.engine import Engine as PEngine
from repro_torch.weights import params_from_jax

# benchmarks/run.py::bench_sched's stream and engine geometry
WL = dict(n_fresh=8, n_followups=28, mean_gap_ns=1600.0, arrival="bursty",
          burst=4, zipf_s=1.8, think_ns=2000.0,
          class_slo_ns=(40_000.0, 150_000.0, float("inf")))


@pytest.fixture(scope="module")
def setup():
    cfg = get_reduced("tinyllama-1.1b")
    rparams = R_lm.init_lm(cfg, jax.random.key(0))
    pparams = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    return cfg, rparams, pparams


def _log_completions(eng, log):
    """Record the tokens of every request the engine completes."""
    step_end = eng.step_end

    def logged(handle):
        done = step_end(handle)
        log.extend((req.uid, list(req.generated)) for _, req in done)
        return done
    eng.step_end = logged


def _run(pkg, setup, policy, cfg_kw, traced):
    cfg, rparams, pparams = setup
    ref = pkg is R
    wl = pkg.WorkloadConfig(**WL)
    arrivals = pkg.generate_workload(wl, seed=4, vocab_size=cfg.vocab_size)
    kw = dict(slots=4, max_len=96, n_sessions=pkg.n_sessions_for(wl))
    eng = (REngine(cfg, rparams, **kw) if ref
           else PEngine(cfg, pparams, device="cpu", **kw))
    tokens = []
    _log_completions(eng, tokens)
    tracer = (RTracer() if ref else PTracer()) if traced else None
    s = pkg.Scheduler(eng, policy=policy, arrivals=arrivals,
                      cfg=pkg.SchedConfig(**cfg_kw), tracer=tracer)
    summary = s.run()
    return s, eng, summary, tokens, tracer


def _same_runs(r, p):
    (rs, reng, rsum, rtok, _), (ps, peng, psum, ptok, _) = r, p
    assert ([dataclasses.astuple(d) for d in ps.metrics.decisions]
            == [dataclasses.astuple(d) for d in rs.metrics.decisions])
    assert psum == rsum
    assert (ps.tick_count, ps.now_ns) == (rs.tick_count, rs.now_ns)
    assert ([(j.job_id, j.uid, j.kind, j.done, j.state, j.done_ns)
             for j in ps.jobs()]
            == [(j.job_id, j.uid, j.kind, j.done, j.state, j.done_ns)
                for j in rs.jobs()])
    assert ptok == rtok
    assert peng.stats == reng.stats
    assert peng.session_tok == reng.session_tok
    for name in ("counters", "hot", "tags", "benefit", "tick"):
        np.testing.assert_array_equal(
            getattr(peng.sessions.policy, name).numpy(),
            np.asarray(getattr(reng.sessions.policy, name)))
    assert peng.hit_rate() == pytest.approx(reng.hit_rate())


@pytest.mark.parametrize("policy", ["fifo", "cost_aware"])
def test_bench_sched_arm_matches_reference(setup, policy):
    r = _run(R, setup, policy, {}, traced=False)
    p = _run(P, setup, policy, {}, traced=False)
    _same_runs(r, p)
    s, eng = p[0], p[1]
    assert len(s.metrics.jobs) == 36
    assert eng.stats["resumes"] == sum(s.metrics.wave_widths("resume_wave"))
    assert eng.stats["decode_dispatches"] == eng.stats["host_transfers"]


def test_contention_arm_matches_reference(setup):
    kw = dict(contention=True, n_banks=4)
    r = _run(R, setup, "cost_aware", kw, traced=False)
    p = _run(P, setup, "cost_aware", kw, traced=False)
    _same_runs(r, p)
    assert p[2]["stalls"]


def test_traced_arm_matches_reference_and_untraced(setup):
    r = _run(R, setup, "cost_aware", {}, traced=True)
    p = _run(P, setup, "cost_aware", {}, traced=True)
    _same_runs(r, p)
    assert p[4].rollup() == r[4].rollup()
    assert p[4].top_spans(5) == r[4].top_spans(5)
    plain = _run(P, setup, "cost_aware", {}, traced=False)
    assert ([dataclasses.astuple(d) for d in p[0].metrics.decisions]
            == [dataclasses.astuple(d) for d in plain[0].metrics.decisions])
    assert {k: v for k, v in p[2].items() if k != "trace"} == plain[2]
