"""Port parity: matrix-free PCoA.

The reference's range-finder sketch ``jax.random.normal(PRNGKey(42),
(n, p))`` cannot be drawn in torch, so it is passed in through ``omega=``.
Eigenvalues agree to rtol 1e-4 and coordinates up to the sign of each
axis to 1e-4 of their scale (the reference's fsvd-vs-eigh gate,
``tests/test_operators.py``); QR and eigh run in another library's order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.core import pcoa as jax_pcoa
from repro.core import random_distance_matrix as jax_random_dm
from repro.core.pcoa import resolve_dimensions as jax_resolve
from repro_torch.core.distance_matrix import DistanceMatrix
from repro_torch.core.pcoa import pcoa, resolve_dimensions, sketch_width


def _reference(n, dim, seed):
    dm = jax_random_dm(jax.random.PRNGKey(seed), n, dim=dim)
    return dm, DistanceMatrix.from_numpy(np.asarray(dm.data), device="cpu")


def _omega(n, k):
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(42), (n, sketch_width(k, n)))))


def _same_up_to_sign(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    for j in range(want.shape[1]):
        a, b = got[:, j], want[:, j]
        assert min(np.abs(a - b).max(), np.abs(a + b).max()) <= tol * scale, j


@pytest.mark.parametrize("n,dims", [(96, 4), (150, 6)])
def test_fsvd_matches_reference_with_its_sketch(n, dims):
    jdm, dm = _reference(n, dims, seed=n)
    want = jax_pcoa(jdm, dimensions=dims)
    got = pcoa(dm, dimensions=dims, omega=_omega(n, dims), device="cpu")
    np.testing.assert_allclose(got.eigenvalues.numpy(),
                               np.asarray(want.eigenvalues), rtol=1e-4)
    np.testing.assert_allclose(got.proportion_explained.numpy(),
                               np.asarray(want.proportion_explained),
                               rtol=1e-4)
    _same_up_to_sign(got.coordinates, want.coordinates, 1e-4)
    assert got.method == "fsvd" and got.coordinates.shape == (n, dims)


def test_materialized_and_eigh_paths_match_reference():
    jdm, dm = _reference(80, 5, seed=1)
    mat = pcoa(dm, dimensions=5, omega=_omega(80, 5), materialize=True,
               device="cpu")
    np.testing.assert_allclose(
        mat.eigenvalues.numpy(),
        np.asarray(jax_pcoa(jdm, dimensions=5, materialize=True).eigenvalues),
        rtol=1e-4)
    for impl in ("fused", "ref"):
        got = pcoa(dm, dimensions=5, method="eigh", centering_impl=impl,
                   device="cpu")
        want = jax_pcoa(jdm, dimensions=5, method="eigh",
                        centering_impl=impl)
        np.testing.assert_allclose(got.eigenvalues.numpy(),
                                   np.asarray(want.eigenvalues), rtol=1e-4)
        _same_up_to_sign(got.coordinates, want.coordinates, 1e-4)
        assert got.key is None


def test_matrix_free_fsvd_matches_eigh_oracle_n512():
    """The reference's acceptance gate, on the port alone: matrix-free
    fsvd coordinates match the eigh oracle to 1e-4 at n=512."""
    _, dm = _reference(512, 6, seed=512)
    r_eigh = pcoa(dm, dimensions=6, method="eigh", device="cpu")
    r_mf = pcoa(dm, dimensions=6, device="cpu")
    assert r_mf.key == 42
    np.testing.assert_allclose(r_mf.eigenvalues.numpy(),
                               r_eigh.eigenvalues.numpy(), rtol=1e-4)
    _same_up_to_sign(r_mf.coordinates, r_eigh.coordinates, 1e-4)


def test_dimensions_rule_matches_reference():
    for dims, n in [(None, 10), (3, 10), (50, 10), (None, 1)]:
        assert resolve_dimensions(dims, n) == jax_resolve(dims, n)
    for bad in (0, -2, 2.5):
        with pytest.raises(ValueError):
            resolve_dimensions(bad, 10)


def test_rejects_bad_input():
    _, dm = _reference(20, 3, seed=2)
    with pytest.raises(ValueError, match="omega"):
        pcoa(dm, dimensions=3, omega=torch.zeros(20, 3), device="cpu")
    with pytest.raises(ValueError, match="method"):
        pcoa(dm, method="svd", device="cpu")
    bad = dm.data.clone()
    bad[0, 1] = bad[1, 0] = float("inf")
    with pytest.raises(ValueError, match="non-finite"):
        pcoa(DistanceMatrix(bad, validate=False, device="cpu"), device="cpu")
