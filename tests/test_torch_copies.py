"""The port's copied modules equal their originals, and the port imports
neither jax nor the reference package."""
import ast
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro import configs as R_cfg
from repro import movement as R_MV
from repro import sched as R_sched
from repro.core.dram import bank as R_bank
from repro.core.dram import spec as R_spec
from repro.core.dram.villa import VillaConfig as R_Villa
from repro.core.lisa import topology as R_topo
from repro.fork import ForkPageTable as R_Fork
from repro.models import lm as R_lm
from repro_torch import configs as P_cfg
from repro_torch import movement as P_MV
from repro_torch import sched as P_sched
from repro_torch.core.dram import bank as P_bank
from repro_torch.core.dram import spec as P_spec
from repro_torch.core.dram.villa import VillaConfig as P_Villa
from repro_torch.core.lisa import topology as P_topo
from repro_torch.core.lisa import villa_cache  # noqa: F401  (registers tier legs)
from repro_torch.fork import ForkPageTable as P_Fork
from repro_torch.models import lm as P_lm

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

# modules the port holds as copies of the reference: the text after the
# two-line header is the reference's, with ``repro`` renamed ``repro_torch``
COPIES = ["configs/__init__.py", "configs/base.py",
          "configs/deepseek_v2_236b.py", "configs/gemma3_27b.py",
          "configs/gemma_7b.py", "configs/jamba_v01_52b.py",
          "configs/olmoe_1b_7b.py", "configs/qwen15_110b.py",
          "configs/qwen2_vl_72b.py", "configs/rwkv6_7b.py",
          "configs/seamless_m4t_medium.py", "configs/tinyllama_11b.py",
          "core/dram/bank.py", "core/dram/spec.py", "core/lisa/topology.py",
          "faults/spec.py", "fork/__init__.py", "fork/table.py",
          "movement/plan.py",
          "obs/__init__.py", "obs/export.py", "obs/tracer.py",
          "sched/__init__.py", "sched/metrics.py", "sched/policy.py",
          "sched/queue.py", "sched/workload.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_reference_module(rel):
    port = (PORT / rel).read_text().split("\n")
    assert port[0].startswith(f"# Port of src/repro/{rel}: a copy")
    want = re.sub(r"\brepro(?=[. ])", "repro_torch", (REF / rel).read_text())
    assert "\n".join(port[2:]) == want


@pytest.mark.parametrize("name", R_cfg.ARCH_NAMES)
def test_configs_equal(name):
    assert P_cfg.ARCH_NAMES == R_cfg.ARCH_NAMES
    for get in ("get_config", "get_reduced"):
        ref, port = getattr(R_cfg, get)(name), getattr(P_cfg, get)(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.layer_kinds() == ref.layer_kinds()
        assert R_cfg.param_count(ref) == P_cfg.param_count(port)


@pytest.mark.parametrize("name", R_spec.preset_names())
def test_presets_and_mechanisms_equal(name):
    ref, port = R_spec.get_preset(name), P_spec.get_preset(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert P_spec.mechanism_names() == R_spec.mechanism_names()
    for m in R_spec.mechanism_names():
        assert (P_spec.get_mechanism(m).coefficients(port)
                == R_spec.get_mechanism(m).coefficients(ref))
        assert port.copy_latency(m) == ref.copy_latency(m)
        assert port.copy_energy(m) == ref.copy_energy(m)
    assert port.table1() == ref.table1()
    np.testing.assert_array_equal(port.mechanism_table(),
                                  ref.mechanism_table())


def test_topology_equal():
    for nbytes in (1024, 46_227_456):
        assert (dataclasses.asdict(P_topo.ici_dram_spec(nbytes))
                == dataclasses.asdict(R_topo.ici_dram_spec(nbytes)))
        assert P_topo.hop_chain_us(3, nbytes) == R_topo.hop_chain_us(3, nbytes)
        assert P_topo.host_path_us(nbytes) == R_topo.host_path_us(nbytes)
    for n in (2, 4, 5):
        pt, rt = P_topo.MeshTopology(n), R_topo.MeshTopology(n)
        assert [[pt.hops(a, b) for b in range(n)] for a in range(n)] == \
               [[rt.hops(a, b) for b in range(n)] for a in range(n)]


def test_plan_costs_equal_for_engine_transfers():
    """The engine's suspend, resume and fork plans (single and fused
    waves) price identically, leg for leg, from each package's own
    PageSpec of the same cache."""
    cfg_r, cfg_p = R_cfg.get_reduced("tinyllama-1.1b"), \
        P_cfg.get_reduced("tinyllama-1.1b")
    r_spec = R_MV.PageSpec.for_cache(R_lm.init_cache(cfg_r, 4, max_len=96))
    p_spec = P_MV.PageSpec.for_cache(P_lm.init_cache(cfg_p, 4, max_len=96,
                                                     device="cpu"))
    assert p_spec.leaf_shapes == r_spec.leaf_shapes
    assert p_spec.leaf_offsets == r_spec.leaf_offsets
    assert (p_spec.total_bytes, p_spec.n_pages) == \
        (r_spec.total_bytes, r_spec.n_pages)
    rv = R_Villa(n_counters=8, n_hot=2, n_slots=2, epoch_len=8)
    pv = P_Villa(n_counters=8, n_hot=2, n_slots=2, epoch_len=8)
    assert dataclasses.asdict(pv) == dataclasses.asdict(rv)
    for src, dst, kind, pol in (("compute", "slow", "move", True),
                                ("slow", "compute", "move", True),
                                ("slow", "slow", "fork", False),
                                ("slow", "fast", "move", False),
                                ("device", "host", "move", False)):
        rp = R_MV.plan(R_MV.Transfer(R_MV.Tier(src), R_MV.Tier(dst),
                                     R_MV.Layout.pages(r_spec),
                                     policy=rv if pol else None, kind=kind))
        pp = P_MV.plan(P_MV.Transfer(P_MV.Tier(src), P_MV.Tier(dst),
                                     P_MV.Layout.pages(p_spec),
                                     policy=pv if pol else None, kind=kind))
        assert tuple(pp.cost) == tuple(rp.cost)
        assert [l.kind for l in pp.legs] == [l.kind for l in rp.legs]
        assert [tuple(c) for c in P_MV.leg_costs(pp)] == \
            [tuple(c) for c in R_MV.leg_costs(rp)]
        if all(l.kind in P_MV.plan.__globals__["_WAVE_KINDS"]
               for l in pp.legs):
            for k in (2, 5):
                assert tuple(P_MV.fuse([pp] * k).cost) == \
                    tuple(R_MV.fuse([rp] * k).cost)


def test_registry_kinds_equal():
    import repro.core.lisa.villa_cache  # noqa: F401  (registers tier legs)
    assert P_MV.backend_kinds() == R_MV.backend_kinds()


def test_fork_table_equal_on_a_random_stream():
    rng = np.random.default_rng(0)
    r, p = R_Fork(), P_Fork()
    next_row = 0
    for _ in range(300):
        op = rng.integers(0, 4)
        uids = sorted(r.phys_of)
        if op == 0 or not uids:
            uid = int(rng.integers(0, 1000))
            if uid in r.phys_of:
                continue
            for t in (r, p):
                t.bind(uid, next_row)
            next_row += 1
        elif op == 1:
            parent, child = int(rng.choice(uids)), int(rng.integers(1000, 2000))
            if child in r.phys_of:
                continue
            assert p.fork_child(parent, child) == r.fork_child(parent, child)
        elif op == 2:
            uid = int(rng.choice(uids))
            got = [t.write_break(uid, alloc=lambda _u, n=next_row: n)
                   for t in (r, p)]
            assert got[0] == got[1]
            next_row += 1
        else:
            uid = int(rng.choice(uids))
            assert p.release(uid) == r.release(uid)
        assert p.phys_of == r.phys_of and p.refs == r.refs
        p.check_conserved()


def test_bank_multiplexer_equal_on_a_random_stream():
    rng = np.random.default_rng(3)
    r = R_bank.RequestMultiplexer(R_spec.DDR3_1600, n_banks=4)
    p = P_bank.RequestMultiplexer(P_spec.DDR3_1600, n_banks=4)
    t = 0.0
    for _ in range(400):
        t += float(rng.exponential(2000.0))
        uid, svc = int(rng.integers(0, 64)), float(rng.uniform(50, 5000))
        assert p.bank_of(uid) == r.bank_of(uid)
        assert (p.submit(p.bank_of(uid), t, svc)
                == r.submit(r.bank_of(uid), t, svc))
        assert p.decode_gate(t) == r.decode_gate(t)
    assert p.snapshot() == r.snapshot()


@pytest.mark.parametrize("arrival", ["poisson", "bursty"])
def test_workload_equal(arrival):
    kw = dict(n_fresh=8, n_followups=28, arrival=arrival, zipf_s=1.8)
    r = R_sched.generate_workload(R_sched.WorkloadConfig(**kw), seed=4,
                                  vocab_size=32000)
    p = P_sched.generate_workload(P_sched.WorkloadConfig(**kw), seed=4,
                                  vocab_size=32000)
    assert len(p) == len(r)
    for a, b in zip(p, r):
        assert a[:6] == b[:6]
        assert (a.prompt is None) == (b.prompt is None)
        if a.prompt is not None:
            np.testing.assert_array_equal(a.prompt, b.prompt)
    assert P_sched.policies() == R_sched.policies()


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_port_imports_without_jax():
    """Every module of the port imports with ``jax`` made unimportable."""
    mods = list(_port_modules())
    assert {"repro_torch.sched.scheduler", "repro_torch.launch.serve",
            "repro_torch.obs.tracer", "repro_torch.core.dram.bank",
            "repro_torch.kernels.rbm_copy"} <= set(mods)
    code = ("import sys, importlib; sys.modules['jax'] = None\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'repro' "
            "or m.startswith('repro.'))\n"
            f"assert not bad, bad\nprint('ok', {len(mods)})")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_or_jax_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("repro", "jax", "jaxlib")]
    assert not bad, f"{path}: imports {bad}"
