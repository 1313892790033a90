"""Port parity of the feature-table path: an (n, d) abundance table →
condensed distances and fused hoists → operator-only PCoA → Mantel,
through ``repro.api.Workspace.from_features`` and through the port's
``repro_torch.api.Workspace.from_features`` on the CPU, on the same
tables.

The port's Mantel is the session's: X permuted through its condensed
vector and fused norm, Y fixed as its hat, B = 32 permutations a tile.
The reference's sketch and orders are passed in. The p-values must be
equal, the statistics agree to 1e-5, the eigenvalues to rtol 1e-4 and the
moments as the reference's own tests hold them (norm rtol 1e-4).
"""

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.api import Workspace
from repro.stats.engine import permutation_orders as jax_orders
from repro_torch.api import ExecConfig
from repro_torch.api import Workspace as TorchWorkspace
from repro_torch.core import (CondensedCenteredGramOperator, DistanceMatrix,
                              mantel, pcoa)
from repro_torch.core.pcoa import sketch_width
from repro_torch.dist import pairwise_condensed, pairwise_distances
from repro_torch.stats import engine

KEY = jax.random.PRNGKey(7)
CPU = "cpu"
CPU_CONFIG = ExecConfig(device=CPU)


def _session(x):
    return TorchWorkspace.from_features(x, "braycurtis", config=CPU_CONFIG)


def _tables(seed, n, d, coupled):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(size=(n, d)))
    x[rng.random(size=x.shape) < 0.3] = 0.0
    if coupled:            # a perturbed copy: a strong, significant Mantel
        y = x * np.exp(0.3 * rng.normal(size=x.shape))
    else:                  # an unrelated table: a p-value inside (0, 1)
        y = np.abs(rng.normal(size=(n, d)))
        y[rng.random(size=y.shape) < 0.3] = 0.0
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("coupled", [True, False])
def test_feature_path_matches_workspace(coupled):
    n, d, dims, permutations = 40, 10, 4, 99
    x, y = _tables(11, n, d, coupled)
    ws_x = Workspace.from_features(x, metric="braycurtis")
    ws_y = Workspace.from_features(y, metric="braycurtis")
    want_pcoa = ws_x.pcoa(dimensions=dims)
    want = ws_x.mantel(ws_y, permutations=permutations, key=KEY)

    tw_x, tw_y = _session(x), _session(y)
    omega = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(42), (n, sketch_width(dims, n)))))
    got_pcoa = tw_x.pcoa(dimensions=dims, omega=omega)
    np.testing.assert_allclose(got_pcoa.eigenvalues.numpy(),
                               np.asarray(want_pcoa.eigenvalues), rtol=1e-4)

    for tw, ws in ((tw_x, ws_x), (tw_y, ws_y)):
        got_m, want_m = tw.moments(), ws.moments()
        np.testing.assert_allclose(float(got_m["norm"]),
                                   float(want_m["norm"]), rtol=1e-4)
        np.testing.assert_allclose(got_m["hat"].numpy(),
                                   np.asarray(want_m["hat"]), rtol=1e-4,
                                   atol=1e-6)

    orders = torch.from_numpy(np.array(jax_orders(KEY, permutations, n)))
    got = tw_x.mantel(tw_y, permutations, orders=orders)
    assert got.sample_size == n and got.permutations == permutations
    assert got.p_value == want.p_value
    assert abs(got.statistic - want.statistic) <= 1e-5
    if coupled:
        assert got.statistic > 0.5 and got.p_value == np.float32(0.01)
    else:
        assert 0.01 < got.p_value < 1.0


def test_feature_path_runs_on_its_own_draws():
    """Without the reference's sketch and orders the port draws its own
    (seeded, not key-compatible with JAX): the same call twice gives the
    same answers."""
    x, y = _tables(12, 30, 8, coupled=True)
    op = CondensedCenteredGramOperator.from_production(
        pairwise_condensed(x, device=CPU))
    a = pcoa(None, dimensions=3, operator=op, device=CPU)
    b = pcoa(None, dimensions=3, operator=op, device=CPU)
    assert torch.equal(a.eigenvalues, b.eigenvalues) and a.key == 42
    assert torch.equal(_session(x).pcoa(dimensions=3).eigenvalues,
                       a.eigenvalues)
    orders = engine.permutation_orders(0, 19, 30)
    r1 = _session(x).mantel(_session(y), 19, orders=orders)
    r2 = _session(x).mantel(_session(y), 19, orders=orders)
    assert r1 == r2 and r1.p_value == np.float32(1 / 20)


def test_production_mantel_is_the_square_mantel():
    """A feature-backed session's Mantel (over the two productions) and
    ``mantel`` over the squares of the same tables run one statistic:
    with the same orders they give the same p-value, and the statistics
    agree to 1e-5 (the production's norm is fused, the square's
    recomputed)."""
    x, y = _tables(13, 25, 7, coupled=False)
    orders = engine.permutation_orders(1, 29, 25)
    got = _session(x).mantel(_session(y), 29, orders=orders)
    stat, p, n = mantel(DistanceMatrix(pairwise_distances(x, device=CPU),
                                       device=CPU),
                        DistanceMatrix(pairwise_distances(y, device=CPU),
                                       device=CPU), 29, orders=orders,
                        device=CPU)
    assert got.sample_size == n == 25 and got.p_value == p
    assert abs(got.statistic - stat) <= 1e-5
    with pytest.raises(ValueError, match="same shape"):
        _session(x).mantel(_session(y[:20]), 9)
