"""Port parity: condensed geometry, dispatch rules and state transfer.

Triangle indexing, its inverse and the square/condensed round trip go
through the reference (JAX on the CPU) and the port on the CPU; all outputs
are integers or copies of inputs, so they must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.core import distance_matrix as jdm
from repro.kernels import dispatch as jdispatch
from repro_torch import convert
from repro_torch.core import distance_matrix as tdm
from repro_torch.kernels import dispatch


@pytest.mark.parametrize("n", [1, 2, 3, 17, 64])
def test_triangle_coords_match_reference(n):
    ii, jj = tdm.triangle_coords(n)
    jii, jjj = jdm.triangle_coords(n)
    assert ii.dtype == jj.dtype == torch.int32
    np.testing.assert_array_equal(ii.numpy(), np.asarray(jii))
    np.testing.assert_array_equal(jj.numpy(), np.asarray(jjj))


@pytest.mark.parametrize("n", [2, 5, 40, tdm.MAX_TRIANGLE_N])
def test_condensed_index_matches_reference(n):
    """Including the largest n at which int32 indexing is exact."""
    rng = np.random.default_rng(n)
    i = rng.integers(0, n, size=500).astype(np.int32)
    j = rng.integers(0, n, size=500).astype(np.int32)
    keep = i != j
    i, j = i[keep], j[keep]
    got = tdm.condensed_index(torch.from_numpy(i), torch.from_numpy(j), n)
    want = jdm.condensed_index(jnp.asarray(i), jnp.asarray(j), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.min()) >= 0 and int(got.max()) < n * (n - 1) // 2


@pytest.mark.parametrize("n", [1, 2, 9, 50])
def test_condensed_round_trip_matches_reference(n):
    dm = jdm.random_distance_matrix(jax.random.PRNGKey(n), n)
    sq = np.asarray(dm.data)
    cond = tdm.DistanceMatrix.from_numpy(sq, device="cpu").condensed_form()
    np.testing.assert_array_equal(cond.numpy(), np.asarray(dm.condensed_form()))
    back = tdm.condensed_to_square(cond, n)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jdm.condensed_to_square(
            dm.condensed_form(), n)))


def test_permute_matches_reference():
    n = 21
    dm = jdm.random_distance_matrix(jax.random.PRNGKey(3), n)
    order = np.random.default_rng(0).permutation(n)
    port = tdm.DistanceMatrix.from_numpy(np.asarray(dm.data), device="cpu")
    np.testing.assert_array_equal(port.permute(order).data.numpy(),
                                  np.asarray(dm.permute(order).data))
    np.testing.assert_array_equal(
        port.permute(order, condensed=True).numpy(),
        np.asarray(dm.permute(order, condensed=True)))


def test_random_distance_matrix_is_valid_and_seeded():
    a = tdm.random_distance_matrix(7, 80, dim=6, device="cpu")
    b = tdm.random_distance_matrix(torch.Generator().manual_seed(7), 80,
                                   dim=6, device="cpu")
    assert torch.equal(a.data, b.data)
    assert a._validated
    tdm.DistanceMatrix(a.data, device="cpu")      # passes validation
    assert not torch.equal(a.data, tdm.random_distance_matrix(
        8, 80, dim=6, device="cpu").data)


@pytest.mark.parametrize("n,requested", [(1, 8), (7, 512), (100, 64),
                                         (1000, 512), (513, 100), (5, 3)])
@pytest.mark.parametrize("lane,floor", [(8, 1), (32, 32), (128, 128)])
def test_snapping_rules_match_reference(n, requested, lane, floor):
    assert dispatch.pick_block(n, requested, lane, floor) == \
        jdispatch.pick_block(n, requested, lane, floor)
    assert dispatch.clamp_block(n, requested) == \
        jdispatch.clamp_block(n, requested)
    assert dispatch.snap_chunk(n * requested, requested * 3) == \
        jdispatch.snap_chunk(n * requested, requested * 3)


def test_lane_geometry_and_device_resolution():
    assert dispatch.lane_geometry("cpu") == (dispatch.SUBLANE, 1)
    assert dispatch.lane_geometry("cuda") == (dispatch.WARP, dispatch.WARP)
    assert dispatch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        dispatch.resolve_device("meta")


def test_from_reference_dtypes_and_keys():
    state = {"data": np.eye(3) * 0, "orders": np.arange(6).reshape(2, 3),
             "omega": np.ones((3, 2)), "normxm": np.float64(2.5)}
    out = convert.from_reference(state, device="cpu")
    assert out["data"].dtype == torch.float32
    assert out["orders"].dtype == torch.int32
    assert out["omega"].dtype == torch.float32
    assert out["normxm"].shape == () and float(out["normxm"]) == 2.5
    with pytest.raises(KeyError, match="weights"):
        convert.from_reference({"weights": np.ones(2)}, device="cpu")
