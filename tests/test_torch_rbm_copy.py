"""K4 (``rbm_copy``) and the ``tile_copy`` leg: the port's plain version and
movement backend against the reference's Pallas kernel (interpret mode on
the CPU) on the same bytes, bit for bit.  The CUDA kernel itself is held to
the plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro import movement as R_MV
from repro.kernels import ops as R_ops
from repro_torch import movement as P_MV
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rbm_copy as RC


def _pair(shape, dtype, seed=0):
    """The same values as a numpy array (for jax) and a torch tensor."""
    rng = np.random.default_rng(seed)
    if dtype == jnp.bfloat16:
        a = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
        return a, torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if np.dtype(dtype) == np.bool_:
        a = rng.integers(0, 2, shape).astype(np.bool_)
    elif np.issubdtype(np.dtype(dtype), np.integer):
        a = rng.integers(-100, 100, shape).astype(dtype)
    else:
        a = rng.standard_normal(shape).astype(dtype)
    return a, torch.from_numpy(a.copy())


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().view(np.uint8).reshape(-1)
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8).reshape(-1)


# tests/test_kernels.py::test_rbm_copy_sweep's cases, then the odd ones
@pytest.mark.parametrize("shape,dtype", [
    ((1000, 333), np.float32),
    ((7, 129, 65), jnp.bfloat16),
    ((4096,), np.int32),
    ((256, 128), np.int8),
    ((13,), np.uint8),
    ((3, 5, 7), np.bool_),
])
def test_rbm_copy_matches_reference(shape, dtype):
    a, x = _pair(shape, dtype)
    want = R_ops.rbm_copy(jnp.asarray(a), tile_rows=64)
    got = ops.rbm_copy(x, tile_rows=64)
    assert got.shape == x.shape and got.dtype == x.dtype
    np.testing.assert_array_equal(_bytes(got), _bytes(want))
    np.testing.assert_array_equal(_bytes(got), _bytes(x))
    # the plain version at a tile that divides nothing
    np.testing.assert_array_equal(
        _bytes(ref.rbm_copy_ref(x, tile_rows=7, lanes=3)), _bytes(x))


def test_rbm_copy_of_an_empty_tensor():
    """The reference's Pallas grid refuses an empty array (a (64, 128)
    block of a (0, 128) operand), so the port is held to its identity
    oracle ``rbm_copy_ref`` here: an empty tensor of the same shape."""
    a, x = _pair((0, 5), np.float32)
    want = R_ops.rbm_copy_ref(jnp.asarray(a))
    got = ops.rbm_copy(x, tile_rows=64)
    assert got.shape == x.shape == want.shape and got.dtype == x.dtype


@pytest.mark.parametrize("dtype", [np.int8, jnp.bfloat16, np.float32])
def test_tile_copy_backend_matches_reference(dtype):
    """tests/test_movement.py::test_tile_copy_backend_bit_exact, through
    both packages' planners and backends on the same bytes."""
    a, x = _pair((37, 129), dtype, seed=1)
    rp = R_MV.plan(R_MV.Transfer(R_MV.Tier("device"), R_MV.Tier("device"),
                                 R_MV.Layout.dense(a.shape, dtype)))
    pp = P_MV.plan(P_MV.Transfer(P_MV.Tier("device"), P_MV.Tier("device"),
                                 P_MV.Layout.dense(a.shape, dtype)))
    assert [leg.kind for leg in pp.legs] == ["tile_copy"]
    assert pp.legs == tuple(P_MV.TileCopyLeg(**vars(leg)) for leg in rp.legs)
    assert tuple(pp.cost) == tuple(rp.cost)
    want = R_MV.execute(rp, data=jnp.asarray(a))["data"]
    got = P_MV.execute(pp, data=x)["data"]
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_array_equal(_bytes(got), _bytes(want))
    assert got.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()


def test_rbm_copy_refuses_a_strided_view():
    x = torch.arange(64, dtype=torch.float32).view(8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rbm_copy(x.t())
    with pytest.raises(ValueError, match="contiguous"):
        ops.rbm_copy(x[:, ::2])
    # a contiguous view with a storage offset is taken as it is
    assert torch.equal(ops.rbm_copy(x.view(-1)[1:]), x.view(-1)[1:])


@pytest.mark.parametrize("tile_rows,lanes", [(0, 128), (-1, 128), (64, 0),
                                             (8, -3)])
def test_rbm_copy_refuses_a_bad_tile(tile_rows, lanes):
    with pytest.raises(ValueError, match="tile_rows and lanes"):
        ops.rbm_copy(torch.zeros(10), tile_rows=tile_rows, lanes=lanes)


def test_cuda_wrapper_takes_cuda_tensors_only():
    with pytest.raises(ValueError, match="CUDA tensor"):
        RC.rbm_copy(torch.zeros(10))

