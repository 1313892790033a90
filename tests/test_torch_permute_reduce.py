"""Port parity: the batched permuted gather-reduce.

The same numpy inputs go through the reference (the Pallas kernel in
interpret mode, and its eager square-roundtrip oracle) and the port's
plain version on the CPU, over several chunks, S in {1, 2} and padded
tails. Tolerance rtol 1e-5 / atol 1e-5 (``tests/test_permute_reduce.py``):
the reference sums in fp32 per chunk, the port in fp64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.kernels.permute_reduce_ops import permute_reduce as jax_reduce
from repro.kernels.permute_reduce_ref import permute_reduce_ref as jax_oracle
from repro_torch.kernels import _build
from repro_torch.kernels.permute_reduce_ops import permute_reduce


def _case(n, perms, rows, seed):
    rng = np.random.default_rng(seed)
    m = n * (n - 1) // 2
    xc = rng.uniform(0.0, 4.0, size=m).astype(np.float32)
    ys = rng.normal(size=(rows, m)).astype(np.float32)
    orders = np.argsort(rng.integers(0, 2**32, size=(perms, n)),
                        axis=-1, kind="stable").astype(np.int32)
    return xc, ys, orders


def _port(xc, ys, orders, chunk=None):
    return permute_reduce(torch.from_numpy(xc), torch.from_numpy(ys),
                          torch.from_numpy(orders), chunk=chunk).numpy()


@pytest.mark.parametrize("n,perms,rows,chunk", [
    (33, 5, 1, 64),     # odd n, m=528: a padded trailing chunk
    (17, 7, 2, 32),     # odd n and B, two stacked rows
    (40, 3, 2, 1024),   # chunk > m: one padded chunk
    (24, 8, 1, 100),    # chunk not a multiple of 8
])
def test_plain_version_matches_pallas_kernel(n, perms, rows, chunk):
    xc, ys, orders = _case(n, perms, rows, seed=n)
    want = jax_reduce(jnp.asarray(xc), jnp.asarray(ys), jnp.asarray(orders),
                      impl="pallas", chunk=chunk, interpret=True)
    got = _port(xc, ys, orders, chunk)
    assert got.shape == (rows, perms) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    oracle = jax_oracle(jnp.asarray(xc), jnp.asarray(ys), jnp.asarray(orders))
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=1e-5, atol=1e-5)


def test_chunking_and_hoisted_coords_do_not_change_the_sum():
    from repro_torch.core.distance_matrix import triangle_coords
    xc, ys, orders = _case(45, 6, 2, seed=1)
    a = _port(xc, ys, orders)
    b = _port(xc, ys, orders, chunk=37)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    ii, jj = triangle_coords(45)
    c = permute_reduce(torch.from_numpy(xc), torch.from_numpy(ys),
                       torch.from_numpy(orders), ii, jj).numpy()
    np.testing.assert_array_equal(a, c)


def test_identity_order_is_plain_dot():
    n = 30
    xc, ys, _ = _case(n, 1, 2, seed=2)
    got = _port(xc, ys, np.arange(n, dtype=np.int32)[None, :])
    np.testing.assert_allclose(got[:, 0], ys.astype(np.float64) @ xc,
                               rtol=1e-6, atol=1e-6)


def test_tiny_n_edges_and_refusals():
    out = _port(np.ones(1, np.float32), np.full((1, 1), 2.0, np.float32),
                np.array([[0, 1], [1, 0]], np.int32))
    np.testing.assert_array_equal(out, [[2.0, 2.0]])
    empty = _port(np.zeros(0, np.float32), np.zeros((2, 0), np.float32),
                  np.zeros((3, 1), np.int32))
    assert empty.shape == (2, 3)
    np.testing.assert_array_equal(empty, 0.0)
    xc, ys, orders = _case(10, 2, 1, seed=3)
    with pytest.raises(ValueError, match="condensed length"):
        _port(xc[:-1], ys, orders)
    with pytest.raises(ValueError, match="ys must be"):
        _port(xc, ys[:, :-1], orders)
    with pytest.raises(ValueError, match="int32"):
        _port(xc, ys, np.zeros((2, 50000), np.int32))
    with pytest.raises(TypeError, match="float32"):
        _port(xc.astype(np.float64), ys, orders)


def test_cpu_path_launches_no_kernel():
    _build.reset_launches()
    xc, ys, orders = _case(20, 4, 1, seed=5)
    _port(xc, ys, orders)
    assert set(_build.launches.values()) == {0}
