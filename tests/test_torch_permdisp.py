"""Port parity: PERMDISP.

The same numpy-seeded matrices and labels go through ``repro.stats`` (JAX
on the CPU) and ``repro_torch.stats`` on the CPU. The reference's orders
are passed in through ``orders=`` and, where the fsvd ordination runs, its
range-finder sketch ``jax.random.normal(PRNGKey(42), (n, p))`` through
``omega=`` (torch cannot draw either). Tolerances are the reference's own
(``tests/test_stats.py``): statistic to 1e-4·max(|s|, 1), p-value to 1e-9.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.core.distance_matrix import DistanceMatrix as JaxDM
from repro.stats import engine as jax_engine
from repro_torch.core.distance_matrix import DistanceMatrix
from repro_torch.core.pcoa import resolve_dimensions, sketch_width
from repro_torch.stats import engine

# the packages export a function named ``permdisp`` over the module's name
jax_permdisp_mod = importlib.import_module("repro.stats.permdisp")
permdisp_mod = importlib.import_module("repro_torch.stats.permdisp")

KEY = jax.random.PRNGKey(7)


def _matrix(n, seed, dim=6, scales=None):
    pts = np.random.default_rng(seed).normal(size=(n, dim))
    if scales is not None:
        pts = pts * scales[:, None]
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)).astype(np.float32)
    d = 0.5 * (d + d.T)
    np.fill_diagonal(d, 0.0)
    return d


def _ref_orders(permutations, n, key=KEY):
    return torch.from_numpy(np.array(jax_engine.permutation_orders(
        key, permutations, n)))


def _ref_omega(n, dimensions):
    k = resolve_dimensions(dimensions, n)
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(42), (n, sketch_width(k, n)))))


def _close(got, want):
    assert abs(got.statistic - want.statistic) < 1e-4 * max(
        abs(want.statistic), 1.0)
    assert abs(got.p_value - want.p_value) < 1e-9


@pytest.mark.parametrize("n,groups,permutations,dimensions,method", [
    (32, 3, 99, None, "fsvd"), (27, 3, 49, None, "fsvd"),
    (40, 4, 49, 5, "fsvd"), (36, 3, 49, 12, "eigh")])
def test_permdisp_matches_reference_with_its_orders(n, groups, permutations,
                                                    dimensions, method):
    d = _matrix(n, n)
    g = np.arange(n) % groups
    want = jax_permdisp_mod.permdisp(JaxDM(jnp.asarray(d)), g,
                                     permutations=permutations, key=KEY,
                                     dimensions=dimensions, method=method)
    got = permdisp_mod.permdisp(
        DistanceMatrix(d, device="cpu"), g, permutations=permutations,
        dimensions=dimensions, method=method,
        orders=_ref_orders(permutations, n),
        omega=_ref_omega(n, dimensions) if method == "fsvd" else None,
        device="cpu")
    _close(got, want)
    assert got.sample_size == n and got.method == "permdisp"


def test_permdisp_detects_dispersion_difference():
    n = 40
    g = np.arange(n) % 2
    d = _matrix(n, 30, dim=3, scales=np.where(g == 0, 0.05, 5.0))
    want = jax_permdisp_mod.permdisp(JaxDM(jnp.asarray(d)), g,
                                     permutations=99, key=KEY)
    got = permdisp_mod.permdisp(DistanceMatrix(d, device="cpu"), g,
                                permutations=99, orders=_ref_orders(99, n),
                                omega=_ref_omega(n, None), device="cpu")
    assert got.statistic > 10.0
    _close(got, want)
    assert got.p_value == pytest.approx(1 / 100)


def test_null_draws_match_reference_on_the_same_coordinates():
    """Both statistics over the same coordinates: the port's batched
    per_batch against the reference's vmapped per_perm, draw for draw."""
    n, k, permutations = 50, 7, 40
    coords = np.random.default_rng(9).normal(size=(n, k)).astype(np.float32)
    codes, groups = engine.encode_grouping(np.arange(n) % 4)
    jstat = jax_permdisp_mod.PermdispStatistic(
        jnp.asarray(coords), jnp.asarray(codes), n, groups)
    observed, permuted = jax_engine._null_distribution(jstat, KEY,
                                                       permutations, 16)
    stat = permdisp_mod.PermdispStatistic(torch.from_numpy(coords),
                                          torch.from_numpy(codes), n, groups)
    inv, got_obs = engine.hoist_and_observe(stat, torch.device("cpu"))
    got = engine.null_distribution(stat, inv, _ref_orders(permutations, n),
                                   16)
    assert abs(float(got_obs) - float(observed)) <= 1e-5 * max(
        abs(float(observed)), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(permuted), rtol=1e-5,
                               atol=1e-5)
    order = _ref_orders(1, n, jax.random.PRNGKey(4))[0]
    np.testing.assert_allclose(float(stat.per_perm(inv, order)),
                               float(stat.per_batch(inv, order[None])[0]),
                               rtol=1e-5, atol=1e-6)


def test_eager_permdisp_ref_matches_reference():
    n, permutations = 26, 19
    d = _matrix(n, 6)
    g = np.arange(n) % 3
    want = jax_permdisp_mod.permdisp_ref(JaxDM(jnp.asarray(d)), g,
                                         permutations=permutations, key=KEY)
    got = permdisp_mod.permdisp_ref(DistanceMatrix(d, device="cpu"), g,
                                    permutations=permutations,
                                    orders=_ref_orders(permutations, n))
    _close(got, want)


def test_permdisp_rejects_bad_groupings():
    dm = DistanceMatrix(_matrix(12, 7), device="cpu")
    with pytest.raises(ValueError, match="length"):
        permdisp_mod.permdisp(dm, np.arange(10) % 2, permutations=9,
                              device="cpu")
    with pytest.raises(ValueError, match="two groups"):
        permdisp_mod.permdisp(dm, ["a"] * 12, permutations=9, device="cpu")
    with pytest.raises(ValueError, match="omega"):
        permdisp_mod.permdisp(dm, np.arange(12) % 2, permutations=9,
                              dimensions=3, omega=torch.zeros(12, 3),
                              device="cpu")
