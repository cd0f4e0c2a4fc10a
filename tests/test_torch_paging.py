"""Paging and the page kernels' plain versions against the reference: pages
and checksums byte-identical for f32 / bf16 / int8 caches, unpack
round-trips, and gather/scatter equal to the Pallas kernels (interpret mode)
including duplicate order; the port's -1 skip equals dropping the entry."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro.kernels import ops as R_ops
from repro.movement import paging as RP
from repro_torch.kernels import ops as P_ops
from repro_torch.movement import paging as PP

REPS, SLOTS, L, K, D = 2, 3, 10, 2, 16


def _cache(kind, rng):
    """A cache tree as numpy arrays — leaves (reps, slots, ...) — shaped
    like the reference's attn caches of dtype ``kind``."""
    def bits(shape, dt):
        if dt == "bf16":      # finite values: the top half of f32 bits
            f = rng.standard_normal(shape).astype(np.float32)
            return (f.view(np.uint32) >> 16).astype(np.uint16), dt
        if dt == "int8":
            return rng.integers(-128, 128, shape, dtype=np.int8), dt
        return rng.standard_normal(shape).astype(np.float32), dt
    kv = (REPS, SLOTS, L, K, D)
    c = {"k": bits(kv, kind), "v": bits(kv, kind),
         "pos": (rng.integers(0, 2**30, (REPS, SLOTS, L), dtype=np.int32),
                 "int32")}
    if kind == "int8":
        c["k_scale"] = bits((REPS, SLOTS, L, K), "f32")
        c["v_scale"] = bits((REPS, SLOTS, L, K), "f32")
    return {"stage0": {"b0": c}}


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    arr, dt = tree
    return jnp.asarray(arr.view(jnp.bfloat16) if dt == "bf16" else arr)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    arr, dt = tree
    t = torch.from_numpy(arr.copy())
    return t.view(torch.bfloat16) if dt == "bf16" else t


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_pages_and_checksums_byte_identical(kind):
    rng = np.random.default_rng(3)
    tree = _cache(kind, rng)
    rc, pc = _to_jax(tree), _to_torch(tree)
    rs, ps = RP.PageSpec.for_cache(rc), PP.PageSpec.for_cache(pc)
    assert (ps.leaf_shapes, ps.leaf_offsets, ps.total_bytes, ps.n_pages) == \
        (rs.leaf_shapes, rs.leaf_offsets, rs.total_bytes, rs.n_pages)
    for slot in range(SLOTS):
        rpages = np.asarray(RP.pack_slot(rs, rc, slot))
        ppages = PP.pack_slot(ps, pc, slot)
        np.testing.assert_array_equal(ppages.numpy(), rpages)
        np.testing.assert_array_equal(
            PP.page_checksums(ppages).numpy(),
            np.asarray(RP.page_checksums(jnp.asarray(rpages))).astype(np.int64))
    # unpack round-trips into a fresh cache, and the reference agrees
    pages = PP.pack_slot(ps, pc, 1)
    fresh = {"stage0": {"b0": {k: torch.zeros_like(v) for k, v in
                               pc["stage0"]["b0"].items()}}}
    PP.unpack_into_slot(ps, fresh, 2, pages)
    ref = RP.unpack_into_slot(rs, _to_jax(tree), 2, jnp.asarray(pages.numpy()))
    for name, leaf in fresh["stage0"]["b0"].items():
        src = pc["stage0"]["b0"][name]
        assert torch.equal(leaf[:, 2].view(torch.uint8) if leaf.dtype ==
                           torch.bfloat16 else leaf[:, 2],
                           src[:, 1].view(torch.uint8) if src.dtype ==
                           torch.bfloat16 else src[:, 1])
        assert not leaf[:, 0].any()
        got = np.asarray(ref["stage0"]["b0"][name])[:, 2]
        want = (leaf[:, 2].view(torch.int16) if leaf.dtype == torch.bfloat16
                else leaf[:, 2]).numpy()
        np.testing.assert_array_equal(got.view(want.dtype), want)


def test_checksum_wraps_mod_2_32_and_catches_one_byte():
    pages = torch.full((2, 8, 128), 255, dtype=torch.uint8)
    want = np.asarray(RP.page_checksums(jnp.asarray(pages.numpy())))
    np.testing.assert_array_equal(PP.page_checksums(pages).numpy(),
                                  want.astype(np.int64))
    bad = pages.clone()
    bad[1, 3, 7] ^= 1
    sums = PP.page_checksums(pages)
    assert int(PP.verify_pages(bad, sums)) == 1
    assert int(PP.verify_pages(pages, sums)) == 0


def test_row_page_table():
    spec = PP.PageSpec(((4,),), (torch.uint8,), (0,), 3000)
    assert PP.row_page_table(spec, 2).tolist() == [6, 7, 8]
    np.testing.assert_array_equal(PP.row_page_table(spec, 5).numpy(),
                                  np.asarray(RP.row_page_table(spec, 5)))


DTYPES = [("float32", torch.float32), ("bfloat16", torch.bfloat16),
          ("int8", torch.int8), ("int32", torch.int32), ("uint8", torch.uint8)]


def _pool(rng, n, dt):
    """(n, 8, 128) pages of ``dt`` as raw bytes and as a tensor; float
    pages hold finite values (a NaN's payload is not preserved by XLA)."""
    if dt.is_floating_point:
        f = rng.standard_normal((n, 8, 128)).astype(np.float32)
        t = torch.from_numpy(f).to(dt)
        return t.view(torch.uint8).numpy().copy(), t
    raw = rng.integers(0, 2**8, (n, 8, 128 * torch.empty((), dtype=dt)
                                 .element_size()), dtype=np.uint8)
    return raw, torch.from_numpy(raw.copy()).view(dt)


@pytest.mark.parametrize("name,dt", DTYPES)
def test_gather_scatter_match_pallas(name, dt):
    rng = np.random.default_rng(4)
    raw, pages = _pool(rng, 16, dt)
    uraw, upd = _pool(rng, 6, dt)
    jdt = jnp.dtype(name)
    rpages = jnp.asarray(raw).view(jdt)
    rupd = jnp.asarray(uraw).view(jdt)
    table = np.array([3, 0, 11, 3, 15, 0], np.int32)        # duplicates
    got = P_ops.villa_gather(pages, table)
    want = R_ops.villa_gather(rpages, jnp.asarray(table))
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                  np.asarray(want.view(jnp.uint8)))
    out = P_ops.villa_scatter(pages.clone(), table, upd)
    want = R_ops.villa_scatter(rpages + 0 if name != "uint8" else rpages,
                               jnp.asarray(table), rupd)
    np.testing.assert_array_equal(out.view(torch.uint8).numpy(),
                                  np.asarray(want.view(jnp.uint8)))
    # last write wins, as in the Pallas grid order
    assert torch.equal(out[3], upd[3]) and torch.equal(out[0], upd[5])


def test_minus_one_skips_like_dropping_the_entry():
    rng = np.random.default_rng(5)
    raw, pages = _pool(rng, 16, torch.uint8)
    _, upd = _pool(rng, 5, torch.uint8)
    table = np.array([4, -1, 9, -1, 4], np.int32)
    keep = table >= 0
    out = P_ops.villa_scatter(pages.clone(), table, upd)
    want = R_ops.villa_scatter(jnp.asarray(raw), jnp.asarray(table[keep]),
                               jnp.asarray(upd.numpy()[keep]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    # a masked gather into an existing buffer keeps the -1 rows
    buf = torch.zeros((5, 8, 128), dtype=torch.uint8)
    P_ops.villa_gather(pages, table, out=buf)
    assert torch.equal(buf[0], pages[4]) and torch.equal(buf[2], pages[9])
    assert not buf[1].any() and not buf[3].any()


def test_out_of_range_tables_raise():
    _, pages = _pool(np.random.default_rng(6), 4, torch.uint8)
    with pytest.raises(IndexError):
        P_ops.villa_gather(pages, [0, 4])
    with pytest.raises(IndexError):
        P_ops.villa_scatter(pages, [-2], pages[:1].clone())
