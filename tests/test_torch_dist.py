"""Port parity: the feature-table production and its metrics.

The same numpy tables go through ``repro.dist`` (JAX, its default row-panel
path) and ``repro_torch.dist`` on the CPU, where each panel is the
kernel's plain chunked version (its feature chunk a module constant; the
reference is given a smaller ``feature_block``, so both sides sum in
chunks, in other orders). Tolerances are the reference's own
(``tests/test_dist.py``): rtol 1e-5 / atol 1e-5 for the distances, the
fused hoists as ``test_fused_hoists_match_square_recomputation`` holds
them. Jaccard is held against ``repro.dist``, not SciPy, whose Jaccard
now works on presence/absence (ROADMAP queue 3).

A Bray–Curtis production of a table below ``SPARSE_SHARE`` nonzero takes
the sparse-support route (each pair summed over one row's nonzeros): it is
held against ``repro.dist`` at the same tolerances, on integer counts bit
for bit against the dense route, and the route rule is checked on what a
session's span and the plain kernels' calls show.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import METRICS as JAX_METRICS
from repro.dist import pairwise_condensed as jax_condensed
from repro.dist import pairwise_distances as jax_distances
from repro.dist.driver import _panel_condensed_indices
from repro_torch.api import ExecConfig, Workspace
from repro_torch.core import DistanceMatrix
from repro_torch.dist import (METRICS, condensed_size, get_metric,
                              pairwise_condensed, pairwise_distances)
from repro_torch.dist import driver
from repro_torch.dist.driver import row_start
from repro_torch.kernels import pairwise_ops
from repro_torch.kernels.pairwise import sparse_rows
from repro_torch.obs import ObsConfig
from repro_torch.obs.ledger import production_floats, sparse_production_floats

CPU = "cpu"


def _table(seed, n, d, nonneg=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    if nonneg:
        x = np.abs(x)
    x[rng.random(size=x.shape) < 0.2] = 0.0   # exact zeros for the guards
    return x.astype(np.float32)


def test_registry_matches_reference():
    assert sorted(METRICS) == sorted(JAX_METRICS)
    assert sorted(m.kind for m in METRICS.values()) == list(range(5))


@pytest.mark.parametrize("metric", sorted(METRICS))
@pytest.mark.parametrize("n,d", [(23, 17), (64, 5), (7, 33), (16, 16)])
def test_metric_matches_reference(metric, n, d):
    x = _table(0, n, d)
    got = pairwise_distances(x, metric, out="condensed", block=16,
                             device=CPU)
    want = np.asarray(jax_distances(x, metric, out="condensed", block=16,
                                    feature_block=8))
    assert got.shape == (condensed_size(n),)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_zero_row_conventions(metric):
    """Two all-zero samples are at distance 0 for every metric, and a zero
    row never gives a non-finite distance."""
    x = _table(1, 12, 9)
    x[0] = 0.0
    x[5] = 0.0
    sq = pairwise_distances(x, metric, block=8, device=CPU).numpy()
    assert sq[0, 5] == 0.0 and sq[5, 0] == 0.0
    assert np.all(np.isfinite(sq))
    want = np.asarray(jax_distances(x, metric, block=8, feature_block=4))
    np.testing.assert_allclose(sq, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["braycurtis", "euclidean"])
def test_production_matches_reference(metric):
    x = _table(5, 33, 9)
    prod = pairwise_condensed(x, metric, block=8, device=CPU)
    want = jax_condensed(x, metric, block=8, feature_block=4)
    assert set(prod) == set(want)
    assert prod["n"] == want["n"] and prod["metric"] == want["metric"]
    np.testing.assert_allclose(prod["condensed"].numpy(),
                               np.asarray(want["condensed"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(prod["row_means"].numpy(),
                               np.asarray(want["row_means"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(prod["global_mean"]),
                               float(want["global_mean"]),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(float(prod["mean"]), float(want["mean"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(prod["norm"]), float(want["norm"]),
                               rtol=1e-4)


def test_fused_hoists_match_square_recomputation():
    x = _table(6, 31, 7)
    prod = pairwise_condensed(x, "braycurtis", block=8, device=CPU)
    sq = pairwise_distances(x, "braycurtis", block=8,
                            device=CPU).numpy().astype(np.float64)
    rm = -0.5 * np.mean(sq * sq, axis=1)
    np.testing.assert_allclose(prod["row_means"].numpy(), rm, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(float(prod["global_mean"]), rm.mean(),
                               rtol=1e-5, atol=1e-8)
    flat = sq[np.triu_indices(31, 1)]
    np.testing.assert_allclose(float(prod["norm"]),
                               np.linalg.norm(flat - flat.mean()), rtol=1e-4)
    moments = Workspace.from_features(
        x, "braycurtis", config=ExecConfig(block=8, device=CPU)).moments()
    np.testing.assert_allclose(moments["hat"].numpy(),
                               (flat - flat.mean()) / np.linalg.norm(
                                   flat - flat.mean()), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n,i0,i1", [(10, 0, 4), (10, 4, 8), (10, 8, 10),
                                     (33, 8, 16), (5, 0, 5)])
def test_panel_mask_selects_the_reference_range(n, i0, i1):
    """The strip's strict upper triangle, in row-major order, is the
    reference's panel index list, and it starts at ``row_start(n, i0)``."""
    strip = torch.arange(i0 * n, i1 * n).reshape(i1 - i0, n)
    upper = torch.arange(n)[None, :] > torch.arange(i0, i1)[:, None]
    got = strip[upper] - i0 * n
    np.testing.assert_array_equal(got.numpy(),
                                  _panel_condensed_indices(n, i0, i1))
    assert row_start(n, i1) - row_start(n, i0) == got.numel()


def test_square_output_is_symmetric_hollow_and_validates():
    x = _table(2, 21, 6)
    for metric in sorted(METRICS):
        sq = pairwise_distances(x, metric, block=8, device=CPU)
        assert torch.equal(sq, sq.T), metric
        assert bool((torch.diagonal(sq) == 0).all()), metric
        DistanceMatrix(sq, device=CPU)        # validation passes


def test_blocks_do_not_change_the_distances():
    x = _table(3, 29, 11)
    a = pairwise_distances(x, "canberra", block=4, device=CPU)
    b = pairwise_distances(x, "canberra", block=256, device=CPU)
    assert torch.equal(a, b)
    c = pairwise_condensed(x, "canberra", block=7, device=CPU)["condensed"]
    assert torch.equal(c, a[torch.ones(29, 29, dtype=torch.bool).triu(1)])


def test_get_metric_and_bad_input():
    assert get_metric("euclidean") is METRICS["euclidean"]
    assert get_metric(METRICS["jaccard"]) is METRICS["jaccard"]
    with pytest.raises(ValueError, match="unknown metric"):
        get_metric("chebyshev")
    with pytest.raises(TypeError):
        get_metric(42)
    with pytest.raises(ValueError, match="feature table"):
        pairwise_condensed(np.zeros(5, np.float32), device=CPU)
    with pytest.raises(ValueError, match="out must be"):
        pairwise_distances(_table(4, 5, 3), out="full", device=CPU)


def test_float64_tables_are_taken_as_float32():
    x = _table(7, 9, 4)
    a = pairwise_condensed(x.astype(np.float64), device=CPU)["condensed"]
    b = pairwise_condensed(jnp.asarray(x), device=CPU)["condensed"]
    assert a.dtype == torch.float32 and torch.equal(a, b)


def _sparse(seed, n, d, share, signed=False):
    """About ``share`` of the entries nonzero; row 0 all zeros, rows 3 and
    7 an all-zero pair."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    if not signed:
        x = np.abs(x)
    x[rng.random(size=x.shape) >= share] = 0.0
    x[[0, 3, 7]] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("share,d", [(0.005, 1531), (0.013, 777),
                                     (0.05, 301)])
def test_sparse_production_matches_reference(share, d, signed):
    x = _sparse(11, 41, d, share, signed)
    assert (x != 0).mean() < driver.SPARSE_SHARE
    prod = pairwise_condensed(x, block=16, device=CPU)
    want = jax_condensed(x, "braycurtis", block=16, feature_block=128)
    np.testing.assert_allclose(prod["condensed"].numpy(),
                               np.asarray(want["condensed"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(prod["row_means"].numpy(),
                               np.asarray(want["row_means"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(prod["global_mean"]),
                               float(want["global_mean"]),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(float(prod["mean"]), float(want["mean"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(prod["norm"]), float(want["norm"]),
                               rtol=1e-4)
    assert float(prod["condensed"][row_start(41, 3) + 3]) == 0.0  # 0/0


def test_sparse_route_gives_the_dense_bits_on_counts(monkeypatch):
    """Integer counts: every partial sum is exact in fp32, so the sparse
    route's distances and hoists are the dense route's, bit for bit."""
    rng = np.random.default_rng(12)
    x = (rng.integers(1, 60, size=(57, 900))
         * (rng.random(size=(57, 900)) < 0.013)).astype(np.float32)
    sparse = pairwise_condensed(x, block=16, device=CPU)
    monkeypatch.setattr(driver, "SPARSE_SHARE", 0.0)
    dense = pairwise_condensed(x, block=16, device=CPU)
    for key in ("condensed", "row_means", "global_mean", "mean", "norm"):
        assert torch.equal(sparse[key], dense[key]), key


def _production_span(x, metric, block=16):
    ws = Workspace.from_features(x, metric, config=ExecConfig(
        block=block, device=CPU, obs=ObsConfig(enabled=True, probe=False)))
    ws.condensed()
    rep = ws.report()
    stack = list(rep.spans)
    while stack:
        span = stack.pop()
        if span["name"] == "dist.pairwise_condensed":
            return span["attrs"], rep.ledger["by_op"]["production"]
        stack.extend(span.get("children", ()))
    raise AssertionError("no dist.pairwise_condensed span")


def test_sparse_route_only_for_sparse_braycurtis_condensed(monkeypatch):
    """The route is ``"sparse"`` only for a Bray–Curtis condensed
    production below ``SPARSE_SHARE``: dense tables, the other metrics and
    ``out="square"`` stay dense. The span says which, with the nonzero
    share, and the ledger charges that route's reads."""
    calls = []
    plain = pairwise_ops.pairwise_sparse_panel_ref
    monkeypatch.setattr(pairwise_ops, "pairwise_sparse_panel_ref",
                        lambda *a: calls.append(a) or plain(*a))
    sparse = _sparse(13, 40, 600, 0.02)
    share = float((sparse != 0).mean())
    attrs, charged = _production_span(sparse, "braycurtis")
    assert attrs["route"] == "sparse"
    assert attrs["nonzero_share"] == pytest.approx(share, rel=1e-12)
    assert len(calls) == 3                    # one a panel of 16 rows
    max_row = int((sparse != 0).sum(axis=1).max())
    assert charged["floats"] == sparse_production_floats(
        40, 600, 16, int((sparse != 0).sum()), sparse_rows(600, max_row))
    calls.clear()
    dense = _table(14, 40, 600)
    attrs, charged = _production_span(dense, "braycurtis")
    assert attrs["route"] == "dense" and attrs["nonzero_share"] > 0.5
    assert charged["floats"] == production_floats(40, 600, 16)
    for metric in ("euclidean", "cityblock", "canberra", "jaccard"):
        attrs, _ = _production_span(sparse, metric)
        assert attrs["route"] == "dense", metric
        assert attrs["nonzero_share"] is None, metric
    sq = pairwise_distances(sparse, "braycurtis", block=16, device=CPU)
    assert calls == []
    assert torch.equal(sq, sq.T)
    np.testing.assert_allclose(
        sq[torch.ones(40, 40, dtype=torch.bool).triu(1)].numpy(),
        pairwise_condensed(sparse, block=16, device=CPU)["condensed"],
        rtol=1e-5, atol=1e-6)
    monkeypatch.setattr(driver, "SPARSE_SHARE", share)   # at the share
    assert _production_span(sparse, "braycurtis")[0]["route"] == "dense"
