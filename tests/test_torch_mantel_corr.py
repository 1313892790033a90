"""Port parity: the materialized Mantel baseline (``mantel_corr``).

The same numpy-seeded matrices and orders go through the reference's
``mantel_corr_pallas`` (the Pallas kernel in interpret mode on the CPU) and
its ``mantel_corr_ref`` oracle, and through the port's ``mantel_corr_op``
on the CPU, where each batch runs the kernel's plain version. Tolerance
rtol 1e-4 / atol 1e-5 (``tests/test_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import pearsonr

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.kernels.mantel_corr_ops import mantel_corr_pallas
from repro.kernels.mantel_corr_ref import mantel_corr_ref as jax_mantel_corr_ref
from repro.stats import engine as jax_engine
from repro_torch.core.distance_matrix import condensed_form
from repro_torch.core.mantel import MantelStatistic
from repro_torch.kernels import _build
from repro_torch.kernels import mantel_corr_ref as mantel_corr_ref_mod
from repro_torch.kernels.mantel_corr import MAX_N, mantel_corr_partials
from repro_torch.kernels.mantel_corr_ops import (mantel_corr_op,
                                                 mantel_corr_sums_op)
from repro_torch.kernels.mantel_corr_ref import (mantel_corr_plain,
                                                 mantel_corr_ref,
                                                 mantel_corr_rows)
from repro_torch.stats import engine

TOL = {"rtol": 1e-4, "atol": 1e-5}


def _matrix(n, seed, dim=5):
    pts = np.random.default_rng(seed).normal(size=(n, dim))
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)).astype(np.float32)
    d = 0.5 * (d + d.T)
    np.fill_diagonal(d, 0.0)
    return d


def _orders(k, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n) for _ in range(k)]).astype(np.int32)


@pytest.mark.parametrize("n,k,perm_batch", [(32, 8, 4), (96, 16, 4),
                                            (50, 8, 8), (37, 6, 3)])
def test_mantel_corr_matches_the_pallas_kernel_and_its_oracle(n, k,
                                                              perm_batch):
    x, y = _matrix(n, n), _matrix(n, n + 1)
    orders = _orders(k, n, n + 2)
    want = np.asarray(mantel_corr_pallas(jnp.asarray(x), jnp.asarray(y),
                                         jnp.asarray(orders),
                                         perm_batch=perm_batch, block=16))
    oracle = np.asarray(jax_mantel_corr_ref(
        jnp.asarray(x), jnp.asarray(y[np.triu_indices(n, 1)]),
        jnp.asarray(orders)))
    tx, ty, to = map(torch.from_numpy, (x, y, orders))
    got = mantel_corr_op(tx, ty, to, perm_batch=perm_batch)
    assert got.dtype == torch.float32 and got.shape == (k,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **TOL)
    port_oracle = mantel_corr_ref(tx, condensed_form(ty), to)
    np.testing.assert_allclose(port_oracle.numpy(), oracle, **TOL)


def test_identity_order_gives_pearson_r():
    n = 40
    x, y = _matrix(n, 3), _matrix(n, 4)
    orders = torch.arange(n, dtype=torch.int32)[None].repeat(4, 1)
    got = mantel_corr_op(torch.from_numpy(x), torch.from_numpy(y), orders,
                         perm_batch=4)
    iu = np.triu_indices(n, 1)
    want = pearsonr(x[iu], y[iu]).statistic
    np.testing.assert_allclose(got.numpy(), np.full(4, want), **TOL)


def test_plain_version_is_the_kernels_function(monkeypatch):
    """stats[b] = Σ_ij x[o_b[i], o_b[j]]·ŷ[i, j], by brute force, with a
    row chunk smaller than n so the chunked sum is exercised."""
    n = 30
    x = torch.from_numpy(_matrix(n, 5))
    yhat = torch.from_numpy(np.random.default_rng(6).normal(
        size=(n, n)).astype(np.float32))
    orders = torch.from_numpy(_orders(5, n, 7))
    want = torch.stack([torch.sum((x[o.long()][:, o.long()] * yhat).double())
                        for o in orders])
    monkeypatch.setattr(mantel_corr_ref_mod, "ROW_CHUNK", 7)
    got = mantel_corr_plain(x, yhat, orders)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


def test_draws_equal_the_condensed_mantel_null():
    """The square-operand draws are the condensed ``permute_reduce`` draws
    of ``MantelStatistic`` for the same orders, and give the same p."""
    n, k = 45, 60
    x, y = _matrix(n, 8), _matrix(n, 9)
    key = jax.random.PRNGKey(0)
    orders = torch.from_numpy(np.array(jax_engine.permutation_orders(
        key, k, n)))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    draws = mantel_corr_op(tx, ty, orders, perm_batch=12)
    stat = MantelStatistic(tx, ty, n)
    inv, observed = engine.hoist_and_observe(stat, torch.device("cpu"))
    want = engine.null_distribution(stat, inv, orders, 32)
    np.testing.assert_allclose(draws.numpy(), want.numpy(), **TOL)
    assert engine.finish(observed, draws, k, "two-sided", n).p_value == \
        engine.finish(observed, want, k, "two-sided", n).p_value


def test_bad_perm_batch_and_shapes_raise():
    n = 12
    x = torch.from_numpy(_matrix(n, 1))
    orders = torch.from_numpy(_orders(6, n, 2))
    with pytest.raises(ValueError, match="divisible by perm_batch"):
        mantel_corr_op(x, x, orders, perm_batch=4)
    with pytest.raises(ValueError, match="divisible by perm_batch"):
        mantel_corr_op(x, x, orders, perm_batch=0)
    with pytest.raises(ValueError, match="orders must be"):
        mantel_corr_op(x, x, orders[:, :5], perm_batch=3)
    with pytest.raises(TypeError, match="float32"):
        mantel_corr_op(x.double(), x, orders, perm_batch=3)
    with pytest.raises(ValueError, match="indices"):
        mantel_corr_op(x, x, orders + 1, perm_batch=3)


def test_cpu_runs_launch_nothing_and_the_kernel_refuses_wide_rows():
    n = 20
    x = torch.from_numpy(_matrix(n, 3))
    _build.reset_launches()
    mantel_corr_op(x, x, torch.from_numpy(_orders(4, n, 4)), perm_batch=2)
    assert _build.launches["mantel_corr"] == 0
    assert _build.launches["mantel_corr_finish"] == 0
    assert _build.launches["inverse_orders"] == 0
    wide = torch.zeros((1, MAX_N + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        mantel_corr_partials(x, x, wide, wide.to(torch.int16))


@pytest.mark.parametrize("n,ranges", [
    (32, [(0, 32)]), (32, [(0, 16), (16, 16)]),
    (96, [(0, 24), (24, 24), (48, 24), (72, 24)]),
    (37, [(0, 3), (3, 20), (23, 14)])])
def test_column_ranges_sum_to_the_square(n, ranges):
    """The kernel's column-range mode (the distributed Mantel's): the sums
    over ŷ's column blocks [c0, c0 + c) add up to the square's, aligned or
    not; the plain version equals the kernel's row-stationary walk on each
    block; the whole range is the square call, bit for bit."""
    x = torch.from_numpy(_matrix(n, n))
    yhat = torch.from_numpy(np.random.default_rng(n).normal(
        size=(n, n)).astype(np.float32))
    orders = torch.from_numpy(_orders(6, n, n + 1))
    want = mantel_corr_plain(x, yhat, orders)
    parts = []
    for c0, c in ranges:
        block = yhat[:, c0:c0 + c].contiguous()
        parts.append(mantel_corr_sums_op(x, block, orders, c0))
        assert torch.equal(parts[-1], mantel_corr_plain(x, block, orders, c0))
        np.testing.assert_allclose(
            parts[-1].numpy(), mantel_corr_rows(x, block, orders, c0).numpy(),
            rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.stack(parts).double().sum(0).numpy(),
                               want.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(mantel_corr_plain(x, yhat, orders, 0), want)
    bad = orders.clone()
    bad[1, 2] = bad[1, 3]
    with pytest.raises(ValueError):
        mantel_corr_sums_op(x, yhat[:, :ranges[0][1]].contiguous(), bad)
