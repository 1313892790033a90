"""Port parity: the partial Mantel test.

The same numpy-seeded matrices go through ``repro.stats`` (JAX on the CPU)
and ``repro_torch.stats`` on the CPU, where each tile is one S = 2
``permute_reduce`` in its plain version. The reference's orders are passed
in through ``orders=``. Tolerances are the reference's own
(``tests/test_stats.py``): statistic to 1e-5, p-value to 1e-9.
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
from repro_torch.kernels import permute_reduce_ops
from repro_torch.stats import engine

# the packages export a function named ``partial_mantel`` over the module's
# name
jax_pm_mod = importlib.import_module("repro.stats.partial_mantel")
pm_mod = importlib.import_module("repro_torch.stats.partial_mantel")

KEY = jax.random.PRNGKey(7)


def _points(n, seed, dim=4):
    return np.random.default_rng(seed).normal(size=(n, dim))


def _matrix(pts):
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)).astype(np.float32)
    d = 0.5 * (d + d.T)
    np.fill_diagonal(d, 0.0)
    return d


def _ref_orders(permutations, n, key=KEY):
    return torch.from_numpy(np.array(jax_engine.permutation_orders(
        key, permutations, n)))


def _both(*mats):
    return ([JaxDM(jnp.asarray(m)) for m in mats],
            [DistanceMatrix(m, device="cpu") for m in mats])


@pytest.mark.parametrize("n,permutations", [(36, 48), (41, 99)])
@pytest.mark.parametrize("alternative", ["two-sided", "greater", "less"])
def test_partial_mantel_matches_reference_with_its_orders(n, permutations,
                                                          alternative):
    base = _points(n, n)
    mats = [_matrix(base), _matrix(0.5 * base + _points(n, n + 1)),
            _matrix(_points(n, n + 2))]
    (jx, jy, jz), (x, y, z) = _both(*mats)
    want = jax_pm_mod.partial_mantel(jx, jy, jz, permutations=permutations,
                                     key=KEY, alternative=alternative)
    got = pm_mod.partial_mantel(x, y, z, permutations=permutations,
                                alternative=alternative,
                                orders=_ref_orders(permutations, n),
                                device="cpu")
    assert abs(got.statistic - want.statistic) < 1e-5
    assert abs(got.p_value - want.p_value) < 1e-9
    assert got.sample_size == n and got.method == "partial_mantel"


def test_null_draws_match_reference_and_stack_two_rows(monkeypatch):
    """Draw for draw against the reference, and every tile is one
    ``permute_reduce`` call over the stacked (ŷ_res, ẑ) pair."""
    n, permutations = 30, 70
    mats = [_matrix(_points(n, s)) for s in (10, 11, 12)]
    jstat = jax_pm_mod.PartialMantelStatistic(*map(jnp.asarray, mats), n)
    observed, permuted = jax_engine._null_distribution(jstat, KEY,
                                                       permutations, 32)
    stat = pm_mod.PartialMantelStatistic(*map(torch.from_numpy, mats), n)
    calls = []
    real = pm_mod.permute_reduce

    def counting(xc, ys, orders, ii=None, jj=None, **kw):
        calls.append(tuple(ys.shape))
        return real(xc, ys, orders, ii, jj, **kw)

    monkeypatch.setattr(pm_mod, "permute_reduce", counting)
    inv, got_obs = engine.hoist_and_observe(stat, torch.device("cpu"))
    got = engine.null_distribution(stat, inv, _ref_orders(permutations, n),
                                   32)
    assert calls == [(2, n * (n - 1) // 2)] * 3
    assert abs(float(got_obs) - float(observed)) <= 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(permuted), rtol=1e-5,
                               atol=1e-5)
    order = _ref_orders(1, n, jax.random.PRNGKey(4))[0]
    np.testing.assert_allclose(float(stat.per_perm(inv, order)),
                               float(stat.per_batch(inv, order[None])[0]),
                               rtol=1e-5, atol=1e-6)
    assert permute_reduce_ops.permute_reduce is real


def test_eager_partial_mantel_ref_matches_reference():
    n, permutations = 24, 19
    (jx, jy, jz), (x, y, z) = _both(*[_matrix(_points(n, s))
                                      for s in (20, 21, 22)])
    want = jax_pm_mod.partial_mantel_ref(jx, jy, jz,
                                         permutations=permutations, key=KEY)
    got = pm_mod.partial_mantel_ref(x, y, z, permutations=permutations,
                                    orders=_ref_orders(permutations, n))
    assert abs(got.statistic - float(want.statistic)) < 1e-5
    assert abs(got.p_value - want.p_value) < 1e-9


def test_partial_mantel_controls_for_a_confounder():
    """y == x keeps the partial r near 1 whatever z; controlling for x
    itself leaves an independent y uncorrelated."""
    n = 36
    x, z, y = (_matrix(_points(n, s)) for s in (16, 17, 18))
    (jx, _, jz), (tx, ty, tz) = _both(x, y, z)
    same = pm_mod.partial_mantel(tx, tx, tz, permutations=32,
                                 orders=_ref_orders(32, n), device="cpu")
    want = jax_pm_mod.partial_mantel(jx, jx, jz, permutations=32, key=KEY)
    assert same.statistic > 0.99 and abs(same.statistic
                                         - want.statistic) < 1e-5
    ctl = pm_mod.partial_mantel(tx, ty, tx, permutations=99,
                                orders=_ref_orders(99, n), device="cpu")
    assert abs(ctl.statistic) < 0.2 and ctl.p_value > 0.01


def test_partial_mantel_rejects_collinear_control_and_bad_shapes():
    n = 20
    x, y = (DistanceMatrix(_matrix(_points(n, s)), device="cpu")
            for s in (1, 2))
    with pytest.raises(ValueError, match="collinear"):
        pm_mod.partial_mantel(x, y, y, permutations=9, device="cpu")
    small = DistanceMatrix(_matrix(_points(n - 1, 3)), device="cpu")
    with pytest.raises(ValueError, match="same shape"):
        pm_mod.partial_mantel(x, y, small, permutations=9, device="cpu")
