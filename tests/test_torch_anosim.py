"""Port parity: ANOSIM.

The same numpy-seeded matrices and labels go through ``repro.stats`` (JAX
on the CPU) and ``repro_torch.stats`` on the CPU, where each tile's
``permute_reduce`` runs its plain version. The reference's orders
(``engine.permutation_orders`` of threefry bits, which torch cannot draw)
are passed in through ``orders=``. Tolerances are the reference's own
(``tests/test_stats.py``): statistic to 1e-5, p-value to 1e-9. The rank
hoist is bitwise the reference's.
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
from repro_torch.stats import engine

# the packages export a function named ``anosim`` over the module's name
jax_anosim_mod = importlib.import_module("repro.stats.anosim")
anosim_mod = importlib.import_module("repro_torch.stats.anosim")

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


@pytest.mark.parametrize("values", [
    np.random.default_rng(0).normal(size=500),
    np.round(np.random.default_rng(1).normal(size=777), 1),     # many ties
    np.zeros(9), np.arange(5.0)[::-1]])
def test_rank_average_is_bitwise_the_reference(values):
    v = values.astype(np.float32)
    want = jax_anosim_mod._rank_average(jnp.asarray(v))
    got = anosim_mod._rank_average(torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(anosim_mod._rankdata(torch.from_numpy(v))
                                  .numpy(), np.asarray(want))


def test_ranks_round_like_the_reference_past_two_to_the_24():
    """Above 2²⁴ the int32 → fp32 cast rounds the ranks (n > 5793 in
    condensed entries); the port rounds exactly as the reference."""
    m = 2**23 + 4097
    v = np.random.default_rng(2).random(m, dtype=np.float32)
    v[::7] = 0.5                                  # one large tie run
    want = np.asarray(jax_anosim_mod._rank_average(jnp.asarray(v)))
    got = anosim_mod._rank_average(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    exact = anosim_mod._rankdata(torch.from_numpy(v).double()).numpy()
    assert np.any(want != exact) and np.abs(want - exact).max() <= 8


def test_rank_transforms_match_reference():
    d = _matrix(30, 3)
    want = jax_anosim_mod.rank_transform(jnp.asarray(d), 30)
    got = anosim_mod.rank_transform(torch.from_numpy(d), 30)
    np.testing.assert_array_equal(got["ranks"].numpy(),
                                  np.asarray(want["ranks"]))
    assert abs(float(got["total_sum"]) - float(want["total_sum"])) <= \
        1e-6 * float(want["total_sum"])


@pytest.mark.parametrize("n,groups,permutations", [
    (36, 3, 99), (40, 4, 49), (23, 2, 70)])
def test_anosim_matches_reference_with_its_orders(n, groups, permutations):
    d = _matrix(n, n)
    g = np.array([f"g{i % groups}" for i in range(n)])
    want = jax_anosim_mod.anosim(JaxDM(jnp.asarray(d)), g,
                                 permutations=permutations, key=KEY)
    got = anosim_mod.anosim(DistanceMatrix(d, device="cpu"), g,
                            permutations=permutations,
                            orders=_ref_orders(permutations, n),
                            device="cpu")
    assert abs(got.statistic - want.statistic) < 1e-5
    assert abs(got.p_value - want.p_value) < 1e-9
    assert got.sample_size == want.sample_size == n
    assert got.permutations == permutations and got.method == "anosim"


def test_anosim_detects_separated_groups():
    n, k = 40, 4
    rng = np.random.default_rng(8)
    g = np.arange(n) % k
    pts = 50.0 * rng.normal(size=(k, 3))[g] + rng.normal(size=(n, 3))
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)).astype(np.float32)
    d = 0.5 * (d + d.T)
    np.fill_diagonal(d, 0.0)
    want = jax_anosim_mod.anosim(JaxDM(jnp.asarray(d)), g, permutations=99,
                                 key=KEY)
    got = anosim_mod.anosim(DistanceMatrix(d, device="cpu"), g,
                            permutations=99, orders=_ref_orders(99, n),
                            device="cpu")
    assert 0.9 < got.statistic <= 1.0
    assert got.p_value == want.p_value == pytest.approx(1 / 100)


def test_null_draws_match_reference():
    n, permutations = 33, 40
    d = _matrix(n, 5)
    codes, groups = jax_engine.encode_grouping(np.arange(n) % 3)
    jstat = jax_anosim_mod.AnosimStatistic(jnp.asarray(d), jnp.asarray(codes),
                                           n, groups)
    observed, permuted = jax_engine._null_distribution(jstat, KEY,
                                                       permutations, 32)
    stat = anosim_mod.AnosimStatistic(torch.from_numpy(d),
                                      torch.from_numpy(codes), n, groups)
    inv, got_obs = engine.hoist_and_observe(stat, torch.device("cpu"))
    got = engine.null_distribution(stat, inv, _ref_orders(permutations, n),
                                   32)
    assert abs(float(got_obs) - float(observed)) <= 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(permuted), rtol=1e-5,
                               atol=1e-5)
    order = _ref_orders(1, n, jax.random.PRNGKey(4))[0]
    np.testing.assert_allclose(float(stat.per_perm(inv, order)),
                               float(stat.per_batch(inv, order[None])[0]),
                               rtol=1e-5, atol=1e-6)


def test_eager_anosim_ref_matches_reference():
    n, permutations = 24, 19
    d = _matrix(n, 6)
    g = np.arange(n) % 3
    want = jax_anosim_mod.anosim_ref(JaxDM(jnp.asarray(d)), g,
                                     permutations=permutations, key=KEY)
    got = anosim_mod.anosim_ref(DistanceMatrix(d, device="cpu"), g,
                                permutations=permutations,
                                orders=_ref_orders(permutations, n))
    assert abs(got.statistic - float(want.statistic)) < 1e-5
    assert abs(got.p_value - want.p_value) < 1e-9


def test_anosim_rejects_bad_groupings():
    dm = DistanceMatrix(_matrix(12, 7), device="cpu")
    with pytest.raises(ValueError, match="length"):
        anosim_mod.anosim(dm, np.arange(10) % 2, permutations=9,
                          device="cpu")
    with pytest.raises(ValueError, match="two groups"):
        anosim_mod.anosim(dm, np.zeros(12), permutations=9, device="cpu")
    with pytest.raises(ValueError, match="size > 1"):
        anosim_mod.anosim(dm, np.arange(12), permutations=9, device="cpu")


@pytest.mark.parametrize("labels", [["a", "b", "a", "c", "b", "a"],
                                    [3, 1, 3, 3], np.array([2.5, 2.5, -1.0])])
def test_encode_grouping_matches_reference(labels):
    codes, groups = engine.encode_grouping(labels)
    want_codes, want_groups = jax_engine.encode_grouping(labels)
    np.testing.assert_array_equal(codes, want_codes)
    assert codes.dtype == want_codes.dtype == np.int32
    assert groups == want_groups
