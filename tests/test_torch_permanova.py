"""Port parity: PERMANOVA, materialized and as an operator.

The same numpy-seeded matrices and labels go through ``repro.stats`` (JAX
on the CPU) and ``repro_torch.stats`` on the CPU, where the Gower hoist is
the ``center`` kernel pair's plain version and each tile is one product
with the (n, B·g) stacked permuted designs. The reference's orders are
passed in through ``orders=``. Tolerances are the reference's own
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
from repro_torch.core import (CenteredGramOperator,
                              CondensedCenteredGramOperator)
from repro_torch.core.distance_matrix import (DistanceMatrix,
                                              condensed_to_square)
from repro_torch.dist import pairwise_condensed
from repro_torch.stats import engine

# the packages export a function named ``permanova`` over the module's name
jax_permanova_mod = importlib.import_module("repro.stats.permanova")
permanova_mod = importlib.import_module("repro_torch.stats.permanova")

KEY = jax.random.PRNGKey(7)


def _matrix(n, seed, dim=4):
    pts = np.random.default_rng(seed).normal(size=(n, dim))
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)).astype(np.float32)
    d = 0.5 * (d + d.T)
    np.fill_diagonal(d, 0.0)
    return d


def _ref_orders(permutations, n, key=KEY):
    return torch.from_numpy(np.array(jax_engine.permutation_orders(
        key, permutations, n)))


def _codes(g):
    codes, groups = engine.encode_grouping(g)
    return torch.from_numpy(codes), groups


@pytest.mark.parametrize("n,groups,permutations", [
    (36, 3, 99), (45, 5, 49), (20, 2, 70)])
def test_permanova_matches_reference_with_its_orders(n, groups,
                                                     permutations):
    d = _matrix(n, n)
    g = np.array([f"s{i % groups}" for i in range(n)])
    want = jax_permanova_mod.permanova(JaxDM(jnp.asarray(d)), g,
                                       permutations=permutations, key=KEY)
    got = permanova_mod.permanova(DistanceMatrix(d, device="cpu"), g,
                                  permutations=permutations,
                                  orders=_ref_orders(permutations, n),
                                  device="cpu")
    assert abs(got.statistic - want.statistic) < 1e-5
    assert abs(got.p_value - want.p_value) < 1e-9
    assert got.sample_size == n and got.method == "permanova"


def test_permanova_detects_group_structure():
    n, k = 45, 3
    rng = np.random.default_rng(3)
    g = np.arange(n) % k
    pts = 25.0 * rng.normal(size=(k, 4))[g] + rng.normal(size=(n, 4))
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)).astype(np.float32)
    d = 0.5 * (d + d.T)
    np.fill_diagonal(d, 0.0)
    want = jax_permanova_mod.permanova(JaxDM(jnp.asarray(d)), g,
                                       permutations=99, key=KEY)
    got = permanova_mod.permanova(DistanceMatrix(d, device="cpu"), g,
                                  permutations=99, orders=_ref_orders(99, n),
                                  device="cpu")
    assert got.statistic > 50.0
    # fp32 SS_within = SS_total − SS_among cancels: each side's relative
    # error is about eps·F(k−1)/(n−k) ≈ 1e-4 at F ≈ 3e4, so the two sums
    # are held to 1e-3 of F here (the reference's own test of this case
    # checks only F > 50 and p)
    assert abs(got.statistic - want.statistic) <= 1e-3 * want.statistic
    assert got.p_value == want.p_value == pytest.approx(1 / 100)


def test_null_draws_and_batched_product_match_reference():
    """The port's per_batch (one product a tile) against the reference's
    vmapped per_perm, draw for draw; per_perm is one column of it."""
    n, permutations = 30, 40
    d = _matrix(n, 4)
    codes, groups = _codes(np.arange(n) % 4)
    jstat = jax_permanova_mod.PermanovaStatistic(
        jnp.asarray(d), jnp.asarray(codes.numpy()), n, groups)
    observed, permuted = jax_engine._null_distribution(jstat, KEY,
                                                       permutations, 16)
    stat = permanova_mod.PermanovaStatistic(torch.from_numpy(d), codes, n,
                                            groups)
    inv, got_obs = engine.hoist_and_observe(stat, torch.device("cpu"))
    got = engine.null_distribution(stat, inv, _ref_orders(permutations, n),
                                   16)
    assert abs(float(got_obs) - float(observed)) <= 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(permuted), rtol=1e-5,
                               atol=1e-5)
    orders = _ref_orders(3, n, jax.random.PRNGKey(4))
    np.testing.assert_allclose(
        stat.per_batch(inv, orders).numpy(),
        torch.stack([stat.per_perm(inv, o) for o in orders]).numpy(),
        rtol=1e-5, atol=1e-6)


def test_operator_form_matches_the_materialized_statistic():
    """Square and condensed operators give the draws of the materialized G
    (the reference's feature-backed ``Workspace.permanova`` branch)."""
    n, permutations = 40, 64
    rng = np.random.default_rng(5)
    x = np.abs(rng.normal(size=(n, 12))).astype(np.float32)
    prod = pairwise_condensed(x, device="cpu")
    square = condensed_to_square(prod["condensed"], n)
    codes, groups = _codes(np.arange(n) % 3)
    orders = _ref_orders(permutations, n)
    mat = permanova_mod.PermanovaStatistic(square, codes, n, groups)
    draws = {}
    for name, op in (
            ("square", CenteredGramOperator.from_distance(square)),
            ("condensed",
             CondensedCenteredGramOperator.from_production(prod, block=16))):
        stat = permanova_mod.PermanovaOperatorStatistic(op, codes, n, groups)
        inv, obs = engine.hoist_and_observe(stat, torch.device("cpu"))
        draws[name] = (obs, engine.null_distribution(stat, inv, orders, 32))
    inv, obs = engine.hoist_and_observe(mat, torch.device("cpu"))
    want = engine.null_distribution(mat, inv, orders, 32)
    for name, (got_obs, got) in draws.items():
        assert abs(float(got_obs) - float(obs)) <= 1e-5, name
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # and the reference's operator statistic over its own condensed operator
    from repro.core.operators import \
        CondensedCenteredGramOperator as JaxCondensedOp
    jop = JaxCondensedOp(jnp.asarray(prod["condensed"].numpy()),
                         jnp.asarray(prod["row_means"].numpy()),
                         jnp.asarray(prod["global_mean"].numpy()), n, 16)
    jstat = jax_permanova_mod.PermanovaOperatorStatistic(
        jop, jnp.asarray(codes.numpy()), n, groups)
    j_obs, j_draws = jax_engine._null_distribution(jstat, KEY, permutations,
                                                   32)
    assert abs(float(draws["condensed"][0]) - float(j_obs)) <= 1e-5
    np.testing.assert_allclose(draws["condensed"][1].numpy(),
                               np.asarray(j_draws), rtol=1e-5, atol=1e-5)


def test_eager_permanova_ref_matches_reference():
    n, permutations = 24, 19
    d = _matrix(n, 6)
    g = np.arange(n) % 3
    want = jax_permanova_mod.permanova_ref(JaxDM(jnp.asarray(d)), g,
                                           permutations=permutations, key=KEY)
    got = permanova_mod.permanova_ref(DistanceMatrix(d, device="cpu"), g,
                                      permutations=permutations,
                                      orders=_ref_orders(permutations, n))
    assert abs(got.statistic - float(want.statistic)) < 1e-5
    assert abs(got.p_value - want.p_value) < 1e-9


def test_permanova_rejects_bad_groupings():
    dm = DistanceMatrix(_matrix(12, 7), device="cpu")
    with pytest.raises(ValueError, match="length"):
        permanova_mod.permanova(dm, np.arange(11) % 2, permutations=9,
                                device="cpu")
    with pytest.raises(ValueError, match="two groups"):
        permanova_mod.permanova(dm, ["a"] * 12, permutations=9, device="cpu")
