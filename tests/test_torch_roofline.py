"""The port's roofline (``repro_torch.roofline``) against the reference's.

* ``model_flops`` equals the reference's for every arch and applicable
  shape; ``roofline_terms`` divides by the H100's peaks.
* The cost model's flops (``FlopCounterMode`` over the port's plain path,
  on the meta device) equal ``repro.roofline.hlo.analyze``'s flops of the
  reference's compiled HLO EXACTLY for reduced tinyllama's decode at 4
  slots and ``max_len`` 96 (2,129,920), for one prefill bucket and for a
  reduced training step: both count the same matmuls, the plain attention
  every pair of its blocks.  No tolerance is needed.
* ``useful_flops`` and the bytes follow their stated formulas.
* The attribution parses a synthetic profiler trace.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro import configs as R_cfg
from repro.configs.base import applicable_shapes
from repro.launch.mesh import make_local_mesh as r_local_mesh
from repro.models import lm as R_lm
from repro.optim import adamw as R_opt
from repro.roofline import analysis as R_RA
from repro.roofline import hlo as R_hlo
from repro.train import step as R_step
from repro_torch import configs as P_cfg
from repro_torch.launch import specs as P_specs
from repro_torch.launch.mesh import StackedAxis
from repro_torch.models import lm as P_lm
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import attribution as AT
from repro_torch.roofline import cost as C
from repro_torch.train import step as P_step

ARCH = "tinyllama-1.1b"
SLOTS, MAX_LEN = 4, 96


@pytest.mark.parametrize("arch", R_cfg.ARCH_NAMES)
def test_model_flops_equal_the_reference(arch):
    rc, pc = R_cfg.get_config(arch), P_cfg.get_config(arch)
    for name in applicable_shapes(rc):
        assert RA.model_flops(pc, P_cfg.SHAPES[name]) == \
            R_RA.model_flops(rc, R_cfg.SHAPES[name])


def test_roofline_terms_use_the_h100_peaks():
    assert (RA.HBM_BW, RA.PEAK_F32_FLOPS, RA.PEAK_TF32_FLOPS,
            RA.PEAK_BF16_FLOPS) == (3.35e12, 67e12, 495e12, 989e12)
    cfg = P_cfg.get_config(ARCH)
    shape = P_cfg.SHAPES["train_4k"]
    cost = {"flops": 989e12, "bytes": 3.35e12, "link_bytes_total": 6.7e12}
    t = RA.roofline_terms(cost, 4, cfg, shape)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(2.0)      # hops at HBM rate
    assert t["dominant"] == "collective_s"
    assert t["model_flops"] == RA.model_flops(cfg, shape)
    assert t["useful_flops_ratio"] == pytest.approx(
        t["model_flops"] / (4 * 989e12))
    # the reference's kernel-adjusted keys equal the plain ones
    assert (t["memory_s_kernel"], t["dominant_kernel"],
            t["roofline_fraction_kernel"]) == (
        t["memory_s"], t["dominant"], t["roofline_fraction"])
    assert RA.peak_flops("float32") == 67e12
    assert RA.peak_flops("bfloat16") == 989e12


# ---------------------------------------------------------------------------
# flops: the cost model against the reference's compiled HLO
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced():
    rcfg = R_cfg.get_reduced(ARCH)
    return rcfg, P_cfg.get_reduced(ARCH), R_lm.init_lm(rcfg,
                                                       jax.random.key(0))


def _hlo_flops(fn, *args):
    return R_hlo.analyze(jax.jit(fn).lower(*args).compile().as_text())[
        "flops"]


def test_decode_flops_equal_the_reference_hlo(reduced):
    rcfg, pcfg, rparams = reduced
    pos = np.array([3, 10, 50, 95], np.int32)
    act = np.array([1, 1, 1, 0], bool)
    want = _hlo_flops(
        lambda p, c, t, q, a: R_lm.decode_step_batched(rcfg, p, c, t, q, a),
        rparams, R_lm.init_cache(rcfg, SLOTS, MAX_LEN),
        jnp.zeros(SLOTS, jnp.int32), jnp.asarray(pos), jnp.asarray(act))
    params = P_specs.param_specs(pcfg, torch.float32)
    cache = P_lm.init_cache(pcfg, SLOTS, MAX_LEN, device="meta")
    got = C.decode_cost(pcfg, params, cache, pos, act)
    assert got["flops"] == want == 2_129_920
    assert got["by_op"] == {"aten.mm": 1_736_704, "aten.bmm": 393_216}
    # useful: attention over each active row's keys 0..pos only
    H, D, L = pcfg.n_heads, pcfg.head_dim, pcfg.n_layers
    valid = int((pos[act] + 1).sum())
    assert got["attention_flops"] == 2 * H * 2 * D * valid * L
    assert got["useful_flops"] == (got["flops"] - 393_216
                                   + got["attention_flops"])


def test_prefill_flops_equal_the_reference_hlo(reduced):
    rcfg, pcfg, rparams = reduced
    lb, n = 32, 20
    q_pos = np.full(lb, 2**30, np.int32)
    q_pos[:n] = np.arange(n)
    want = _hlo_flops(
        lambda p, t, c, q: R_lm.prefill(rcfg, p, t, c, positions=q),
        rparams, jnp.zeros((1, lb), jnp.int32),
        R_lm.init_cache(rcfg, 1, MAX_LEN), jnp.asarray(q_pos)[None])
    params = P_specs.param_specs(pcfg, torch.float32)
    cache = P_lm.init_cache(pcfg, 1, MAX_LEN, device="meta")
    got = C.prefill_cost(pcfg, params, cache, lb, q_pos)
    assert got["flops"] == want == 14_942_208
    pairs = C.valid_pairs(q_pos[None], q_pos[None])
    # the 20 tokens' causal pairs, and every pad row over all 32 keys
    assert pairs == n * (n + 1) // 2 + (lb - n) * lb
    assert got["attention_flops"] == (2 * pcfg.n_heads * 2 * pcfg.head_dim
                                      * pairs * pcfg.n_layers)


def test_train_step_flops_equal_the_reference_hlo(reduced):
    rcfg, pcfg, _ = reduced
    rp = R_step.ParallelConfig(fsdp=False)
    state = R_step.init_train_state(rcfg, jax.random.key(0), rp)
    _, compile_step, _ = R_step.make_train_step(
        rcfg, r_local_mesh(1, 1), rp, R_opt.OptConfig(), donate=False)
    B, S = 4, 64
    batch = {"tokens": jnp.zeros((B, S), jnp.int32),
             "labels": jnp.zeros((B, S), jnp.int32)}
    shapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                          (state, batch))
    want = R_hlo.analyze(compile_step(*shapes).lower(*shapes).compile()
                         .as_text())["flops"]
    pp = P_step.ParallelConfig(fsdp=False)
    params = P_specs.param_specs(pcfg, torch.float32)
    meta = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
            for k in ("tokens", "labels")}
    got = C.count_flops(P_step.grads_of, pcfg, pp, params, meta)
    assert got["flops"] == want == 383_778_816


def test_count_flops_on_meta_equals_the_cpu_count(reduced):
    _, pcfg, rparams = reduced
    from repro_torch.weights import params_from_jax
    cpu = params_from_jax(rparams, device="cpu")
    toks = torch.zeros(SLOTS, dtype=torch.int32)
    pos = torch.tensor([3, 10, 50, 95], dtype=torch.int32)
    act = np.array([1, 1, 1, 0], bool)
    on_cpu = C.count_flops(P_lm.decode_step_batched, pcfg, cpu,
                           P_lm.init_cache(pcfg, SLOTS, MAX_LEN,
                                           device="cpu"), toks, pos, act)
    on_meta = C.count_flops(P_lm.decode_step_batched, pcfg, C.to_meta(cpu),
                            P_lm.init_cache(pcfg, SLOTS, MAX_LEN,
                                            device="meta"),
                            toks.to("meta"), pos.to("meta"), act)
    assert on_cpu == on_meta


def test_moe_counts_on_meta():
    """An MoE router's ``bincount`` has no meta kernel: the cost model
    answers it with its ``minlength`` bins, the count matching the CPU's."""
    cfg = P_cfg.get_reduced("olmoe-1b-7b")
    params = P_lm.init_lm(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    toks = torch.zeros((2, 16), dtype=torch.int32)
    on_cpu = C.count_flops(P_lm.forward, cfg, params, toks)
    on_meta = C.count_flops(P_lm.forward, cfg, C.to_meta(params),
                            toks.to("meta"))
    assert on_cpu == on_meta and on_cpu["flops"] > 0


def test_bytes_and_bound(reduced):
    _, pcfg, _ = reduced
    params = P_specs.param_specs(pcfg, torch.float32)
    cache = P_lm.init_cache(pcfg, SLOTS, MAX_LEN, device="meta")
    pos = np.array([3, 10, 50, 95])
    act = np.array([1, 1, 1, 1], bool)
    got = C.decode_cost(pcfg, params, cache, pos, act)
    row = pcfg.n_kv_heads * 2 * pcfg.head_dim * 4
    L = pcfg.n_layers
    stacked = sum(x.numel() * 4 for x in _leaves(params)) - \
        params["embed"].numel() * 4
    assert got["bytes"] == (stacked + SLOTS * pcfg.d_model * 4
                            + row * int((pos + 1).sum()) * L
                            + row * SLOTS * L + 4 * SLOTS * (MAX_LEN + 1) * L)
    assert C.bound_ms(got) == pytest.approx(
        max(got["bytes"] / RA.HBM_BW,
            got["gemm_flops"] / RA.PEAK_F32_FLOPS
            + got["attention_flops"] / RA.PEAK_F32_FLOPS) * 1e3)
    move = C.page_move_cost(3, 1000, 4)
    assert move["bytes"] == 3 * (2 * 1000 + 8 * 4)
    assert C.bound_by(move) == "bytes"


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_attention_bound_counts_valid_pairs():
    q = torch.zeros(1, 4, 2, 8)
    k = torch.zeros(1, 6, 1, 8)
    qp = torch.tensor([[0, 1, 2, 3]])
    kp = torch.tensor([[0, 1, 2, 3, 2**30, 2**30]])
    ms, by = C.attention_bound(q, k, qp, kp, 0)
    nbytes = 4 * 1 * 4 * 2 * 16 + 4 * 16 * 4 * 1 + 4 * (4 + 6)
    flops = 2 * 2 * 16 * 10
    assert ms == pytest.approx(max(nbytes / RA.HBM_BW,
                                   flops / RA.PEAK_F32_FLOPS) * 1e3)
    assert by == "bytes"
    assert C.tc_bound(q, k, qp, kp, 0) == pytest.approx(max(
        nbytes / RA.HBM_BW, 3 * flops / RA.PEAK_TF32_FLOPS) * 1e3)


def test_axis_counts_hop_and_reduction_bytes():
    ax = StackedAxis(4, "cpu", "x")
    x = torch.zeros(4, 3, 5)
    ax.ppermute(x, [(0, 1), (1, 2)])
    ax.psum(torch.zeros(4, 7, dtype=torch.float64))
    assert (ax.hops, ax.hop_bytes) == (1, 3 * 5 * 4)
    assert (ax.reductions, ax.reduction_bytes) == (1, 7 * 8)
    ax.reset_counts()
    assert (ax.hop_bytes, ax.reduction_bytes) == (0, 0)


# ---------------------------------------------------------------------------
# attribution: device time by kernel from a profiler trace
# ---------------------------------------------------------------------------

def _trace():
    k = lambda name, ts, dur: {"ph": "X", "cat": "kernel",  # noqa: E731
                               "name": name, "ts": ts, "dur": dur}
    return [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
         "dur": 5.0},
        k("(anonymous namespace)::gather_kernel(uint4 const*, uint4*)",
          10.0, 20.0),
        k("(anonymous namespace)::gather_kernel(uint4 const*, uint4*)",
          40.0, 20.0),
        k("(anonymous namespace)::dedupe_kernel(int const*)", 60.0, 5.0),
        k("(anonymous namespace)::scatter_kernel(uint4*)", 65.0, 10.0),
        k("void pf::prefill_kernel<float, float, 64>(float const*)", 80.0,
          50.0),
        # overlaps the prefill kernel: busy time is the union
        k("void at::native::(anonymous namespace)::vectorized_gather_"
          "kernel<16, long>(char*)", 100.0, 40.0),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 150.0,
         "dur": 10.0},
        {"ph": "i", "name": "marker", "ts": 200.0},
    ]


def test_attribution_parses_a_trace(tmp_path):
    got = AT.attribute(_trace())
    assert got["window_ms"] == pytest.approx(0.2)
    assert got["busy_ms"] == pytest.approx((20 + 20 + 5 + 10 + 60 + 10)
                                           / 1e3)
    assert got["busy_share"] == pytest.approx(got["busy_ms"] / 0.2)
    # kernels and copies apart: the share divides by the kernels' time
    assert got["kernel_ms"] == pytest.approx((20 + 20 + 5 + 10 + 60) / 1e3)
    assert got["copy_ms"] == pytest.approx(10 / 1e3)
    assert got["launches"] == 6 and got["copies"] == 1
    assert got["dominant"].startswith("void pf::prefill_kernel")
    copy_only = [e for e in _trace() if e.get("cat") != "kernel"]
    assert AT.attribute(copy_only)["dominant"] is None
    assert [r["kind"] for r in AT.attribute(copy_only)["kernels"]] == [
        "copy"]
    assert got["port_kernels"] == {
        "K2 villa_gather": {"device_ms": pytest.approx(0.04), "count": 2},
        "K1 villa_scatter": {"device_ms": pytest.approx(0.015), "count": 2},
        "K3 flash_attention": {"device_ms": pytest.approx(0.05),
                               "count": 1}}
    torch_gather = [r for r in got["kernels"]
                    if "vectorized_gather" in r["name"]]
    assert torch_gather[0]["port"] is None
    assert AT.attribute(_trace(), window_ms=1.0)["busy_share"] == \
        pytest.approx(got["busy_ms"])
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _trace()}))
    assert AT.load(str(path)) == _trace()
    assert AT.main([str(path)]) == 0


def test_every_port_kernel_is_named():
    """Each ``__global__`` function of the port's CUDA sources is one of
    :data:`attribution.PORT_KERNELS`, so a trace counts every launch of a
    kernel of ours under its counter (K3e's backward: its prep, widening
    and gradients kernels)."""
    import re
    from pathlib import Path

    csrc = Path(AT.__file__).resolve().parents[1] / "kernels" / "csrc"
    names = set()
    for src in csrc.glob("*.cu"):
        names |= set(re.findall(r"__global__[^{;]*?\b(\w+_kernel)\s*\(",
                                src.read_text()))
    assert {"prefill_wgmma_kernel", "prep_kernel", "widen_kernel",
            "grads_kernel"} <= names
    for n in names:
        assert AT.port_kernel(f"void ns::{n}<float, 64>(float const*)"), n
    assert AT.port_kernel("void ns::prep_kernel<float>(float*)") == (
        "K3e flash_attention_backward")


def _region_trace():
    """Host launches and their device records, paired by correlation id;
    the session dropped the first two records (before the region), and
    one record of the region sits ahead of its launch on the trace's
    clock, as the device and host clocks allow."""
    def call(name, ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
                "dur": 1.0, "args": {"correlation": corr}}

    def rec(cat, name, ts, dur, corr):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}
    lead = [call("cudaLaunchKernel", 1.0 + i, i) for i in range(4)]
    lead += [rec("kernel", "fill", 5.0 + i, 1.0, i) for i in (2, 3)]
    return lead + [
        call("cudaDeviceSynchronize", 9.0, 90),
        {"ph": "X", "cat": "user_annotation", "name": AT.REGION,
         "ts": 10.0, "dur": 100.0},
        call("cudaLaunchKernel", 11.0, 10),
        rec("kernel", "(anonymous namespace)::gather_kernel(uint4*)", 8.0,
            20.0, 10),
        call("cuLaunchKernel", 30.0, 11),
        rec("kernel", "void cutlass::Kernel2<sgemm>(Params)", 40.0, 30.0,
            11),
        call("cudaMemcpyAsync", 50.0, 12),
        rec("gpu_memcpy", "Memcpy HtoD", 75.0, 5.0, 12),
        call("cudaLaunchHostFunc", 60.0, 13),
        call("cudaDeviceSynchronize", 100.0, 14),
        # launched after the region: not the region's
        call("cudaLaunchKernel", 120.0, 15),
        rec("kernel", "fill", 121.0, 1.0, 15),
    ]


def test_attribution_of_a_region_by_correlation():
    """A region's device records are those of the launches made inside
    it, matched by correlation id whatever their timestamps; a launch,
    copy or set without its record counts as ``unrecorded``; the window
    defaults to the region's span."""
    got = AT.attribute(_region_trace(), region=AT.REGION)
    assert (got["launches"], got["copies"], got["unrecorded"]) == (2, 1, 0)
    assert got["kernel_ms"] == pytest.approx((20 + 30) / 1e3)
    assert got["copy_ms"] == pytest.approx(5 / 1e3)
    assert got["window_ms"] == pytest.approx(0.1)
    assert got["dominant"] == "void cutlass::Kernel2<sgemm>(Params)"
    assert got["port_kernels"] == {
        "K2 villa_gather": {"device_ms": pytest.approx(0.02), "count": 1}}
    # the whole trace: the two dropped lead-in records show
    whole = AT.attribute(_region_trace())
    assert (whole["launches"], whole["unrecorded"]) == (5, 2)
    # a record of the region dropped is counted
    short = [e for e in _region_trace()
             if e.get("args", {}).get("correlation") != 11
             or e["cat"] != "kernel"]
    got = AT.attribute(short, region=AT.REGION)
    assert (got["launches"], got["unrecorded"]) == (1, 1)
    with pytest.raises(ValueError, match="no region"):
        AT.attribute(_region_trace(), region="elsewhere")


def test_attribution_of_a_cpu_profile():
    """A CPU run's trace has no device events: nothing busy, every op
    counted out of the window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    got = AT.attribute(AT.from_profiler(prof))
    assert got["busy_ms"] == 0 and got["launches"] == 0
    assert got["kernel_ms"] == 0 and got["copy_ms"] == 0
    assert got["window_ms"] > 0
