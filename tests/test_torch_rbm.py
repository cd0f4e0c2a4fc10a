"""The port's RBM hop primitives (``core/lisa/rbm.py``) and
``compression.allreduce_mean_compressed`` against the reference's.

The reference runs once, in a subprocess with 8 forced host devices, over
a mesh of 8 and one of 4 (``shard_map``; its outputs fetched whole with
``np.asarray``).  The port runs the same numpy inputs on
``StackedAxis(n, device="cpu")`` here at n = 8 and 4, and on a
``GroupAxis`` over 4 gloo ranks (``_torch_ranks.run_gloo``).  Hops, copies,
broadcasts and gathers are bit-exact; the reduce-scatter and all-reduce
are bit-equal too (each device's adds run in the reference's order).
"""
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _multidev import run_with_devices
from _torch_ranks import rbm_cases, run_gloo, run_stacked
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.launch.mesh import StackedAxis

NS = (8, 4)
GLOO = 4                                    # the gloo run's ranks

REF = r"""
import json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core.lisa import rbm, compression as C

tmp, specs = {tmp!r}, json.loads({specs!r})
for n in (8, 4):
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))
    z = np.load(f"{{tmp}}/in_{{n}}.npz")

    def smap(f, n_in=1, n_out=1):
        def body(*s):
            got = f(*[a[0] for a in s])
            return (tuple(g[None] for g in got) if n_out > 1
                    else got[None])
        out_specs = (P("x"),) * n_out if n_out > 1 else P("x")
        return jax.jit(jax.shard_map(body, mesh=mesh,
                                     in_specs=(P("x"),) * n_in,
                                     out_specs=out_specs))

    out = {{}}
    for name, (fn, pre, kw, key) in specs[str(n)].items():
        kw = {{("axis" if k == "dim" else k): v for k, v in kw.items()}}
        f = lambda s, fn=fn, pre=pre, kw=kw: getattr(rbm, fn)(
            s, *pre, "x", **kw)
        out[name] = np.asarray(smap(f)(z[key]))
    out["matmul"] = np.asarray(smap(
        lambda xs, ws: rbm.ring_allgather_matmul(xs, ws, "x"), 2)(
            z["mx"], z["mw"]))
    mean, err = smap(lambda g: C.allreduce_mean_compressed(
        g, jnp.zeros_like(g), "x"), 1, 2)(z["g"])
    out["compressed_mean"], out["compressed_err"] = (np.asarray(mean),
                                                     np.asarray(err))
    np.savez(f"{{tmp}}/ref_{{n}}.npz", **out)
print("REF_OK")
"""


def _inputs(n: int) -> dict:
    rng = np.random.default_rng(100 + n)
    f32 = np.float32
    return {"x": rng.standard_normal((n, 2, 3), f32),
            "rs": rng.standard_normal((n, n, 5, 3), f32),
            "ar": rng.standard_normal((n, 3, 5), f32),       # 15: padded
            "mx": rng.standard_normal((n, 5, 2 * n), f32),
            "mw": rng.standard_normal((n, 2, 3), f32),
            "g": rng.standard_normal((n, 1000), f32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": {n: outputs}, "stacked": {n: outputs}, "gloo": outputs}."""
    tmp = tmp_path_factory.mktemp("rbm")
    inputs = {n: _inputs(n) for n in NS}
    for n in NS:
        np.savez(tmp / f"in_{n}.npz", **inputs[n])
    specs = json.dumps({str(n): rbm_cases(n) for n in NS})
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_with_devices,
                          REF.format(tmp=str(tmp), specs=specs), 8)
        gloo_dir = tmp / "gloo"
        gloo_dir.mkdir()
        gloo = run_gloo(["rbm", "raises"], GLOO, inputs[GLOO], {}, gloo_dir)
        stacked = {n: run_stacked("rbm", n, inputs[n], {}) for n in NS}
        assert "REF_OK" in ref.result()
    return {"ref": {n: dict(np.load(tmp / f"ref_{n}.npz")) for n in NS},
            "stacked": stacked, "gloo": gloo, "inputs": inputs}


def _runs_of(runs, n):
    """The port's runs at axis size n: the stack, and the gloo ranks."""
    got = [("stacked", runs["stacked"][n])]
    if n == GLOO:
        got.append(("gloo", runs["gloo"]["rbm"]))
    return got


MOVES = [(n, name) for n in NS for name, (fn, *_) in rbm_cases(n).items()
         if fn in ("rbm_hop", "lisa_copy", "lisa_broadcast",
                   "ring_allgather")]
SUMS = [(n, name) for n in NS for name in ("reduce_scatter", "allreduce")]


@pytest.mark.parametrize("n,name", MOVES)
def test_moves_bit_exact(runs, n, name):
    """Hops (both directions), lisa_copy over the ring and along a linear
    chain (and src == dst), lisa_broadcast to a subset and to all, and the
    ring all-gather on dims 0 and 1: every byte the reference's."""
    want = runs["ref"][n][name]
    for kind, got in _runs_of(runs, n):
        assert got[name].shape == want.shape, kind
        assert np.array_equal(got[name], want), kind


@pytest.mark.parametrize("n,name", SUMS)
def test_reductions_bit_equal(runs, n, name):
    """The reduce-scatter (and the all-reduce built on it, padded: 15
    values over n devices) adds each device's chunks in the reference's
    order, so the sums are bit-equal."""
    want = runs["ref"][n][name]
    for kind, got in _runs_of(runs, n):
        assert np.array_equal(got[name], want), kind
    # and they are the sums
    x = runs["inputs"][n]["rs" if name == "reduce_scatter" else "ar"]
    dense = (x.sum(0) if name == "reduce_scatter"
             else np.broadcast_to(x.sum(0), x.shape))
    np.testing.assert_allclose(want, dense, atol=1e-5)


@pytest.mark.parametrize("n", NS)
def test_allgather_matmul(runs, n):
    """x @ w_full from hop-by-hop partial products, within 1e-5 of the
    reference's (each partial a torch.matmul, the reference's XLA's)."""
    want = runs["ref"][n]["matmul"]
    x, w = runs["inputs"][n]["mx"], runs["inputs"][n]["mw"]
    np.testing.assert_allclose(want, x @ w.reshape(-1, w.shape[-1]),
                               atol=1e-4)
    for kind, got in _runs_of(runs, n):
        np.testing.assert_allclose(got["matmul"], want, atol=1e-5,
                                   err_msg=kind)


def _codes(g, err):
    """The int8 codes a device sent, recovered from its error feedback:
    ``err = g - q * scale`` with the axis's shared scale."""
    scale = np.float32(max(np.abs(g).max(), 1e-12)) / np.float32(127.0)
    return np.rint((g - err) / scale)


@pytest.mark.parametrize("n", NS)
def test_allreduce_mean_compressed(runs, n):
    """int8 codes with the shared (pmax) scale equal the reference's but
    for half-step straddles (at most 0.1%), and the mean is within 2e-2 of
    the exact mean (the reference test's bar)."""
    g = runs["inputs"][n]["g"]
    ref = runs["ref"][n]
    want_codes = _codes(g, ref["compressed_err"])
    for kind, got in _runs_of(runs, n):
        codes = _codes(g, got["compressed_err"])
        assert np.mean(codes != want_codes) <= 1e-3, kind
        np.testing.assert_allclose(got["compressed_mean"],
                                   np.broadcast_to(g.mean(0), g.shape),
                                   atol=2e-2, err_msg=kind)
        assert np.abs(got["compressed_mean"]
                      - ref["compressed_mean"]).max() <= 2e-2, kind


@pytest.mark.parametrize("n", NS)
def test_ring_scan_makes_n_hops_and_no_collective(runs, n):
    """The stand-in for the reference's collective-permute HLO check: a
    ring_scan is n hops (the last one's result unused, as the reference's
    loop) and no reduction; an axis has no all-gather to call."""
    for kind, got in _runs_of(runs, n):
        assert got["scan_counts"].tolist() == [[n, 0]] * n, kind
    assert not hasattr(StackedAxis, "all_gather")


def test_gloo_axis_refuses_cuda_and_other_devices(runs):
    """A GroupAxis on a gloo group refuses device="cuda" (NCCL's), and a
    tensor on another device than the axis's raises, never moved."""
    assert runs["gloo"]["raises"]["raised"].all()


def test_stacked_axis_without_a_gpu_raises(monkeypatch):
    """StackedAxis(n) runs on cuda unless asked for the CPU: with no GPU it
    raises rather than fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StackedAxis(4)
    assert StackedAxis(4, device="cpu").device.type == "cpu"


def test_ppermute_pairs_are_checked():
    """jax.lax.ppermute's rules: indices on the axis, no source or
    destination named twice; a device that receives nothing gets zeros."""
    ax = StackedAxis(4, device="cpu")
    x = torch.arange(8.0).reshape(4, 2) + 1
    with pytest.raises(ValueError, match="outside"):
        ax.ppermute(x, [(0, 4)])
    with pytest.raises(ValueError, match="twice"):
        ax.ppermute(x, [(0, 1), (2, 1)])
    with pytest.raises(ValueError, match="leading dim"):
        ax.ppermute(x[:3], [(0, 1)])
    got = ax.ppermute(x, [(2, 0)])
    assert torch.equal(got, torch.stack([x[2]] + [torch.zeros(2)] * 3))


def test_hop_rows_take_the_largest_power_of_two_up_to_64_kib():
    """A shard is viewed as rows of the largest power of two that divides
    its bytes, at most HOP_ROW_BYTES (64 KiB): a 549,978,112-byte shard (one
    eighth of tinyllama's f32 weights) is 8,392 rows, not 537,088 of 1 KiB;
    a shard that is no multiple of 16 bytes has to be padded (0)."""
    from repro_torch.launch.mesh import HOP_ROW_BYTES, hop_rows
    assert HOP_ROW_BYTES == 64 * 1024
    assert hop_rows(549_978_112) == 64 * 1024
    assert 549_978_112 // hop_rows(549_978_112) == 8392
    for nbytes, want in ((2**30, 2**16), (3 * 1024, 1024), (48, 16),
                         (16, 16), (65536 * 3, 65536), (36, 0), (5, 0)):
        assert hop_rows(nbytes) == want, nbytes


@pytest.mark.parametrize("shape,dt,pairs", [
    ((8, 5), torch.uint8, [(i, (i + 1) % 8) for i in range(8)]),
    ((4, 3, 3), torch.float32, [(0, 2), (3, 1)]),
    ((1, 1000), torch.float32, [(0, 0)]),
    ((4, 64, 32), torch.bfloat16, [(2, 2), (0, 1)]),
    ((8, 4096), torch.int32, [(7, 0)]),
    ((8, 3 * 65536), torch.uint8, [(2, 3)]),                 # 64 KiB rows
    ((8, 2 * 65536 + 1024), torch.uint8, [(i, (i + 1) % 8)
                                          for i in range(8)]),
])
def test_stacked_hop_on_cpu_is_the_plain_gather(shape, dt, pairs):
    """stacked_hop on the CPU (the plain gather of the hop's table, at
    the rows hop_rows gives) against the hop written out: out[d] = x[s]
    for each pair, zeros where a device receives nothing."""
    from repro_torch.launch.mesh import stacked_hop
    g = torch.Generator().manual_seed(41)
    x = torch.randn(shape, generator=g).mul(50).to(dt)
    got = stacked_hop(x, tuple(pairs))
    want = torch.zeros_like(x)
    for s, d in pairs:
        want[d] = x[s]
    assert got.dtype == dt and got.shape == x.shape
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
