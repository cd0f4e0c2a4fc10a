"""The port's ring attention (``core/lisa/ring_attention.py``) against the
reference's, at its test's shapes (B 2, S 128, H 8, K 4, D 32).

The reference runs once, in a subprocess with 8 forced host devices
(``shard_map`` over the sequence); the port runs the same numpy inputs on
``StackedAxis(n, device="cpu")`` at n = 8 and 4 and on a ``GroupAxis`` over
4 gloo ranks.  Causal and non-causal outputs are within 3e-5 of the
reference's (the reference test's bar against its dense oracle), and of
the port's plain attention over the whole sequence (K3's plain version).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _multidev import run_with_devices
from _torch_ranks import run_gloo, run_stacked
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.kernels import ref as K

B, S, H, KV, D = 2, 128, 8, 4, 32
NS = (8, 4)
GLOO = 4
BAR = 3e-5

REF = r"""
import numpy as np, jax
from jax.sharding import PartitionSpec as P
from repro.core.lisa.ring_attention import ring_attention

mesh = jax.make_mesh((8,), ("sp",))
z = np.load({path!r})
out = {{}}
for causal in (True, False):
    ring = jax.jit(jax.shard_map(
        lambda q_, k_, v_: ring_attention(q_, k_, v_, "sp", causal=causal),
        mesh=mesh, in_specs=P(None, "sp"), out_specs=P(None, "sp")))
    out[f"causal_{{causal}}"] = np.asarray(ring(z["q"], z["k"], z["v"]))
np.savez({out!r}, **out)
print("REF_OK")
"""


def _inputs():
    rng = np.random.default_rng(7)
    return {"q": rng.standard_normal((B, S, H, D), np.float32),
            "k": rng.standard_normal((B, S, KV, D), np.float32),
            "v": rng.standard_normal((B, S, KV, D), np.float32)}


def _shard(a, n):
    """(B, S, ...) -> (n, B, S/n, ...): device i holds tokens i*S/n..."""
    return np.ascontiguousarray(
        a.reshape((B, n, S // n) + a.shape[2:]).swapaxes(0, 1))


def _unshard(a):
    n = a.shape[0]
    return a.swapaxes(0, 1).reshape((B, n * a.shape[2]) + a.shape[3:])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    full = _inputs()
    np.savez(tmp / "in.npz", **full)
    local = {n: {k: _shard(a, n) for k, a in full.items()} for n in NS}
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_with_devices, REF.format(
            path=str(tmp / "in.npz"), out=str(tmp / "ref.npz")), 8)
        gloo_dir = tmp / "gloo"
        gloo_dir.mkdir()
        gloo = run_gloo(["ring_attention"], GLOO, local[GLOO], {},
                        gloo_dir)["ring_attention"]
        stacked = {n: run_stacked("ring_attention", n, local[n], {})
                   for n in NS}
        assert "REF_OK" in ref.result()
    return {"ref": dict(np.load(tmp / "ref.npz")), "full": full,
            "port": [(f"stacked {n}", n, stacked[n]) for n in NS]
            + [(f"gloo {GLOO}", GLOO, gloo)]}


RUNS = [f"stacked {n}" for n in NS] + [f"gloo {GLOO}"]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("run", RUNS)
def test_ring_attention_matches_reference(runs, run, causal):
    _, n, got = next(r for r in runs["port"] if r[0] == run)
    out = _unshard(got[f"causal_{causal}"])
    want = runs["ref"][f"causal_{causal}"]
    assert out.shape == want.shape == (B, S, H, D)
    err = float(np.abs(out - want).max())
    assert err < BAR, (run, causal, err)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_plain_attention(runs, causal):
    """Against the port's plain attention over the whole sequence (K3's
    plain version, which chip_smoke holds K3 to on the card)."""
    t = {k: torch.from_numpy(a) for k, a in runs["full"].items()}
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    want = K.chunked_attention_ref(t["q"], t["k"], t["v"], pos, pos,
                                   causal=causal).numpy()
    for run, _, got in runs["port"]:
        err = float(np.abs(_unshard(got[f"causal_{causal}"]) - want).max())
        assert err < BAR, (run, causal, err)


@pytest.mark.parametrize("run", RUNS)
def test_ring_attention_is_n_hops(runs, run):
    """The KV shards rotate through ring_scan: n hops a call and no
    reduction (the reference's collective-permute HLO check)."""
    _, n, got = next(r for r in runs["port"] if r[0] == run)
    for causal in (True, False):
        assert got[f"counts_{causal}"].tolist() == [[n, 0]] * n
