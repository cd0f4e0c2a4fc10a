"""The port's analyzer (``repro_torch.analysis``) analyzed: every lint rule
fires exactly once on its planted fixture, as the reference's rules do at
the reference's paths; each torch sync idiom fires once; the port's tree
lints clean with an empty waiver file; the entry-point auditor catches a
reallocated in-place argument, a sync and a uint8 upcast; the default
targets audit clean on the CPU; a wave launches what one call does.

Fixtures are PARSED, never imported.
"""
import json
import os

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro.analysis import lint as R_lint
from repro_torch.analysis import dispatch as D
from repro_torch.analysis import entrypoints as E
from repro_torch.analysis import testlib as TL
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.dispatch import AuditTarget, EntryContract
from repro_torch.analysis.findings import Finding, Report, load_waivers
from repro_torch.analysis.lint import find_repo_root, lint_file, run_lint
from repro_torch.analysis.rules import (LintRule, get_rule, register_rule,
                                        rule_ids)
from repro_torch.configs import get_reduced
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.serve.engine import Engine, Request

HERE = os.path.dirname(__file__)
FIXTURES = os.path.join(HERE, "fixtures", "lint")
TORCH_FIXTURES = os.path.join(HERE, "fixtures", "lint_torch")
ROOT = os.path.dirname(HERE)


def _source(directory, name):
    with open(os.path.join(directory, name)) as f:
        return f.read()


def _to_port(path):
    """A reference path mapped into the port's tree."""
    if path.startswith("src/repro/"):
        return "src/repro_torch/" + path[len("src/repro/"):]
    return "src/repro_torch/" + path.split("/", 1)[1]


# the reference's planted fixtures (tests/test_analysis.py's PLANTED)
PLANTED = [
    ("raw_backend.py", "src/repro/serve/sneaky.py", "movement-raw-backend"),
    ("host_sync_tick.py", "src/repro/sched/scheduler.py",
     "host-sync-in-hot-loop"),
    ("nan_json.py", "benchmarks/fixture.py", "json-nan"),
    ("wallclock.py", "src/repro/sched/fixture.py",
     "wallclock-in-virtual-clock"),
    ("import_reg.py", "src/repro/movement/fixture.py",
     "import-time-registration"),
    ("unref_alias.py", "src/repro/serve/fixture.py", "unrefcounted-alias"),
    ("unclosed_span.py", "src/repro/obs/fixture.py", "unclosed-span"),
]


@pytest.mark.parametrize("fixture,ref_path,rule", PLANTED,
                         ids=[p[2] for p in PLANTED])
def test_reference_fixture_fires_once_as_in_the_reference(fixture, ref_path,
                                                          rule):
    src = _source(FIXTURES, fixture)
    path = _to_port(ref_path)
    got = lint_file(path, src)
    want = R_lint.lint_file(ref_path, src)
    assert [f.rule for f in got] == [rule], got
    assert got[0].path == path and got[0].line > 0
    assert [(f.rule, f.line) for f in got] == [(f.rule, f.line)
                                               for f in want]


TORCH_IDIOMS = sorted(f for f in os.listdir(TORCH_FIXTURES)
                      if f.endswith(".py"))


@pytest.mark.parametrize("fixture", TORCH_IDIOMS)
def test_torch_sync_idiom_fires_once(fixture):
    src = _source(TORCH_FIXTURES, fixture)
    for path in ("src/repro_torch/sched/scheduler.py",
                 "src/repro_torch/serve/engine.py"):
        got = lint_file(path, src)
        assert [f.rule for f in got] == ["host-sync-in-hot-loop"], got
        assert "finding" in src.splitlines()[got[0].line - 1]
    # outside the tick loop's modules the same code is clean
    assert lint_file("src/repro_torch/roofline/cost.py", src) == []


def test_torch_idioms_are_all_planted():
    assert TORCH_IDIOMS == sorted(
        f"sync_{n}.py" for n in ("asarray", "bool", "bool_call", "cpu",
                                 "float", "int", "int_call", "int_subscript",
                                 "item", "numpy", "synchronize", "tolist"))


@pytest.mark.parametrize("path", [
    "src/repro_torch/movement/backends.py", "src/repro_torch/kernels/ops.py",
    "src/repro_torch/core/lisa/rbm.py", "src/repro_torch/launch/mesh.py"])
def test_raw_backend_allowed_where_the_bytes_move(path):
    src = _source(FIXTURES, "raw_backend.py")
    assert lint_file(path, src) == []


def test_rules_do_not_reach_the_reference_tree():
    """The port's rules scope the port: the reference's own paths are the
    reference analyzer's business."""
    src = _source(FIXTURES, "raw_backend.py")
    assert lint_file("src/repro/serve/sneaky.py", src) == []


def test_host_sync_sanctioned_functions_are_structural():
    src = ("class Engine:\n"
           "    def step_end(self, handle):\n"
           "        return handle.cpu().numpy()\n"
           "    def fast_resident_uids(self):\n"
           "        return self.sessions.policy.tags.cpu().tolist()\n"
           "    def tick_helper(self, handle):\n"
           "        return handle.item()\n")
    findings = lint_file("src/repro_torch/serve/engine.py", src)
    assert [(f.rule, f.line) for f in findings] == [
        ("host-sync-in-hot-loop", 7)]


def test_host_sync_out_of_scope_module_is_clean():
    src = "def f(x):\n    return x.item(), x.cpu(), int(x.sum())\n"
    assert lint_file("src/repro_torch/roofline/cost.py", src) == []


# ---------------------------------------------------------------------------
# the real tree is clean; the waiver file is empty; the committed report
# ---------------------------------------------------------------------------

def test_clean_tree_zero_findings_empty_waivers():
    root = find_repo_root()
    report = run_lint(repo_root=root)
    assert report.roots == ["src/repro_torch"]
    assert report.findings == [], [str(f) for f in report.findings]
    assert report.waived == []
    assert report.waiver_file == "LINT_WAIVERS_torch"
    assert report.files_scanned > 50
    assert set(report.rules) == set(rule_ids())
    assert load_waivers(os.path.join(root, "LINT_WAIVERS_torch")) == []


def _refuse_constant(name):
    raise ValueError(f"{name} is not strict JSON")


def test_committed_report_is_clean_and_covers_every_target():
    with open(os.path.join(ROOT, "LINT_REPORT_torch.json")) as f:
        rep = json.loads(f.read(), parse_constant=_refuse_constant)
    assert rep["schema"] == "repro-lint-report/v1"
    assert rep["counts"]["findings"] == 0 and rep["counts"]["waived"] == 0
    assert rep["roots"] == ["src/repro_torch"]
    assert rep["waiver_file"] == "LINT_WAIVERS_torch"
    assert rep["audit"]["findings"] == [] and rep["audit"]["device"] == "cpu"
    names = [t["name"] for t in rep["audit"]["targets"]]
    buckets = rep["audit"]["prefill_buckets"]
    assert sorted(names) == sorted(
        ["decode", "suspend", "suspend_many", "resume", "resume_many",
         "migrate", "simulate_params"]
        + [f"prefill[bucket={b}]" for b in buckets])
    assert all(t["syncs"] == 0 for t in rep["audit"]["targets"])


def test_report_is_strict_json(tmp_path):
    rep = Report(roots=["src/repro_torch"], rules=["json-nan"],
                 findings=[Finding("json-nan", "a.py", 1, "m")])
    path = tmp_path / "r.json"
    rep.write(str(path))
    assert json.loads(path.read_text())["counts"]["findings"] == 1
    rep.audit = {"bad": float("nan")}
    with pytest.raises(ValueError):
        rep.write(str(path))


def test_rule_registry_contract():
    from repro_torch.analysis.rules import JsonNanRule
    assert register_rule(JsonNanRule) is JsonNanRule

    with pytest.raises(ValueError, match="already registered"):
        @register_rule
        class Impostor(LintRule):
            id = "json-nan"
    assert type(get_rule("json-nan")).__name__ == "JsonNanRule"
    with pytest.raises(ValueError, match="unknown lint rule"):
        get_rule("no-such-rule")


def test_cli_strict_lint_exits_zero(capsys):
    assert cli_main(["--strict"]) == 0
    assert "0 finding(s), 0 waived" in capsys.readouterr().out


def test_cli_audit_runs_on_the_card_unless_asked(monkeypatch):
    """The audit is an entry point of the port: it runs on the card unless
    the caller names the CPU, and raises where there is no card."""
    seen = []

    def targets(**kw):
        seen.append(kw.get("device"))
        raise RuntimeError("stop")

    monkeypatch.setattr(E, "default_targets", targets)
    with pytest.raises(RuntimeError, match="stop"):
        cli_main(["--audit", "--rules", "json-nan"])
    with pytest.raises(RuntimeError, match="stop"):
        cli_main(["--audit", "--rules", "json-nan", "--device", "cpu"])
    assert seen == [None, "cpu"]
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.default_targets()


# ---------------------------------------------------------------------------
# the auditor on planted entry points
# ---------------------------------------------------------------------------

class _Holder:
    def __init__(self):
        self.cache = {"k": torch.zeros(4, 8)}
        self.pages = torch.zeros(2, 64, dtype=torch.uint8)


def _target(fn, holder, contract):
    return AuditTarget("fixture", fn, (), contract,
                       state=lambda: {"cache": holder.cache,
                                      "pages": holder.pages})


def test_audit_reallocated_inplace_state_fires():
    h = _Holder()

    def reallocate():
        h.cache = {"k": h.cache["k"] + 1.0}        # a copy, not in place

    rec, findings = D.audit_target(_target(
        reallocate, h, EntryContract(inplace=frozenset({"cache"}))))
    assert [f.rule for f in findings] == ["audit-inplace"]
    assert rec["syncs"] == 0


def test_audit_inplace_write_is_clean():
    h = _Holder()

    def write():
        h.cache["k"].add_(1.0)

    rec, findings = D.audit_target(_target(
        write, h, EntryContract(inplace=frozenset({"cache"}))))
    assert findings == [] and rec["inplace_tensors"] == 1


def test_audit_item_fires():
    h = _Holder()

    def leaky():
        h.cache["k"].add_(float(h.cache["k"].sum().item()))

    rec, findings = D.audit_target(_target(
        leaky, h, EntryContract(inplace=frozenset({"cache"}))))
    assert [f.rule for f in findings] == ["audit-host-transfer"]
    assert rec["syncs"] == 1


def test_audit_uint8_upcast_fires():
    h = _Holder()

    def upcast():
        h.cache["k"][:2].copy_(h.pages.float().sum(-1, keepdim=True))

    rec, findings = D.audit_target(_target(
        upcast, h, EntryContract(uint8_preserving=True)))
    assert [f.rule for f in findings] == ["audit-dtype"]
    assert rec["uint8_upcasts"] == 1


def test_audit_bitcast_page_path_is_clean():
    h = _Holder()

    def bitcast():
        h.cache["k"].view(-1)[:8].copy_(h.pages[0, :32].view(torch.float32))

    rec, findings = D.audit_target(_target(
        bitcast, h, EntryContract(uint8_preserving=True)))
    assert findings == [] and rec["uint8_upcasts"] == 0


def test_plain_versions_host_table_checks_are_not_syncs():
    """On the CPU a page kernel's plain version range-checks its host table
    with ``bool()``; on the card a host table is checked on the host, so
    the audit leaves those reads out — and still counts the caller's."""
    pool = torch.zeros(8, 4, 16, dtype=torch.uint8)
    table = torch.tensor([1, 3], dtype=torch.int32)
    rec, _ = D.audit_target(AuditTarget(
        "fixture", lambda: ops.villa_gather(pool, table), (),
        EntryContract(no_host_transfer=False)))
    assert rec["syncs"] == 0
    rec, _ = D.audit_target(AuditTarget(
        "fixture", lambda: bool(ops.villa_gather(pool, table).any()), (),
        EntryContract(no_host_transfer=False)))
    assert rec["syncs"] == 1


def test_audit_bucket_stability():
    class FakeEngine:
        max_len = 32

        def _bucket_len(self, n):
            return n

    assert D.audit_bucket_stability(FakeEngine(), [16, 32]) != []

    class Bucketed(FakeEngine):
        def _bucket_len(self, n):
            return min(max(16, 1 << (n - 1).bit_length()), self.max_len)

    assert D.audit_bucket_stability(Bucketed(), [16, 32]) == []


def test_bucket_audit_holds_the_engine_to_its_declared_buckets(monkeypatch):
    """The declared set is the Engine's documented one, not the image of
    its ``_bucket_len``: a bucketing that strays from it is a finding."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine

    cfg = get_reduced("tinyllama-1.1b")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    eng = Engine(cfg, params, slots=1, max_len=96, n_sessions=1,
                 device="cpu")
    assert E.prefill_buckets(eng) == [16, 32, 64, 96]
    assert D.audit_bucket_stability(eng, E.prefill_buckets(eng)) == []
    monkeypatch.setattr(eng, "_bucket_len",
                        lambda n: min(max(8, 1 << (n - 1).bit_length()), 96))
    got = D.audit_bucket_stability(eng, E.prefill_buckets(eng))
    assert [f.rule for f in got] == ["audit-prefill-buckets"]


@pytest.fixture(scope="module")
def audited():
    targets, engine = E.default_targets(device="cpu")
    extra = D.audit_bucket_stability(engine, E.prefill_buckets(engine))
    return D.run_audit(targets, extra_findings=extra), engine


def test_default_targets_audit_clean(audited):
    """Every registered entry point keeps its contract on the CPU at
    reduced geometry: state in place, no sync, uint8 pages."""
    audit, engine = audited
    assert audit["findings"] == [], audit["findings"]
    by = {t["name"]: t for t in audit["targets"]}
    assert {"decode", "suspend", "suspend_many", "resume", "resume_many",
            "migrate", "simulate_params"} <= set(by)
    assert [n for n in by if n.startswith("prefill[")] == [
        f"prefill[bucket={b}]" for b in E.prefill_buckets(engine)]
    for name in ("suspend", "suspend_many", "resume", "resume_many",
                 "migrate"):
        assert by[name]["uint8_upcasts"] == 0
    assert by["resume"]["inplace"] == ["cache", "fail", "store"]
    assert all(t["syncs"] == 0 for t in audit["targets"])


def _engine(slots=4, n_sessions=8):
    cfg = get_reduced("tinyllama-1.1b")
    params = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(cfg, params, slots=slots, max_len=32,
                 n_sessions=n_sessions, device="cpu")
    rng = np.random.default_rng(0)
    for uid in range(slots):
        eng.submit(Request(uid, rng.integers(0, cfg.vocab_size, 5).astype(
            np.int32), 40))
    return eng


def test_prefill_insert_leaves_its_token_on_the_device():
    """F4 (ROADMAP Queue 3): the prefill entry point read its next token
    (``int(argmax)``) inside it, a sync the reference's jitted prefill does
    not make; the read is the submit's, after it."""
    eng = _engine(slots=1)
    toks = np.zeros(16, np.int32)
    got = eng._prefill_insert(toks, np.arange(16, dtype=np.int32), 16, 0)
    assert isinstance(got, torch.Tensor) and got.dim() == 0
    rec, findings = D.audit_target(AuditTarget(
        "prefill", eng._prefill_insert,
        (toks, np.arange(16, dtype=np.int32), 16, 0), EntryContract()))
    assert findings == [] and rec["syncs"] == 0


def test_resume_keeps_the_store_in_place():
    """F6 (ROADMAP Queue 3): a resume replaced the store's policy state
    and counters with new tensors where the reference donates the store."""
    eng = _engine()
    eng._suspend_many_fn([0, 1], [0, 1])
    before = [t.data_ptr() for t in D.tensors(eng.sessions)]
    eng._resume_fn(2, 0)
    eng._resume_many_fn([2, 3], [0, 1])
    assert [t.data_ptr() for t in D.tensors(eng.sessions)] == before
    assert int(eng.sessions.accesses) == 3


@pytest.mark.parametrize("entry", ["suspend", "resume"])
def test_a_wave_moves_pages_in_one_call_s_launches(entry, monkeypatch):
    """F5 (ROADMAP Queue 3): the reference's wave is ONE dispatch; the
    port's ran a K1/K2 call per session.  The page kernels' calls a wave
    makes are a single call's, at every width."""
    calls = {"villa_gather": 0, "villa_scatter": 0}

    def counted(name):
        fn = getattr(ops, name)

        def wrap(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrap

    for name in calls:
        monkeypatch.setattr(ops, name, counted(name))
    eng = _engine()
    per = {}
    for width in (1, 2, 4):
        slots = list(range(width))
        eng._suspend_many_fn(slots, slots)
        for name in calls:
            calls[name] = 0
        if entry == "suspend":
            eng._suspend_many_fn(slots, slots)
        else:
            eng._resume_many_fn(slots, slots)
        per[width] = dict(calls)
    for name in calls:
        calls[name] = 0
    if entry == "suspend":
        eng._suspend_fn(0, 0)
        want = E.SUSPEND_LAUNCHES
    else:
        eng._resume_fn(0, 0)
        want = E.RESUME_LAUNCHES
    single = {k: want.get(k, 0) for k in calls}
    assert dict(calls) == single
    assert per == {w: single for w in (1, 2, 4)}


def test_testlib_dispatch_delta_reads_the_engine():
    eng = _engine(slots=2)
    before = TL.snapshot_stats(eng)
    for _ in range(3):
        eng.step()
    TL.assert_dispatch_delta(before, TL.snapshot_stats(eng), decode=3,
                             host=3)
    with pytest.raises(AssertionError, match="decode dispatches"):
        TL.assert_dispatch_delta(before, TL.snapshot_stats(eng), decode=2)
