"""Port parity: the condensed-backed centred-Gram operator and the
operator-only PCoA entry.

Productions of the same numpy table by ``repro.dist`` and
``repro_torch.dist`` (CPU) back the reference's and the port's
``CondensedCenteredGramOperator``. Tolerances are the reference's
(``tests/test_dist.py::test_condensed_operator_matches_square_operator``):
matvec rtol 1e-4 / atol 1e-4, trace rtol 1e-5, the square rtol 1e-6 /
atol 1e-6; PCoA eigenvalues rtol 1e-4 with the reference's sketch
``jax.random.normal(PRNGKey(42), (n, p))`` passed in as ``omega``, since
torch cannot draw it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.core import CondensedCenteredGramOperator as JaxCondensedOperator
from repro.core import pcoa as jax_pcoa
from repro.dist import pairwise_condensed as jax_condensed
from repro_torch.core import (CenteredGramOperator,
                              CondensedCenteredGramOperator, DistanceMatrix,
                              pcoa)
from repro_torch.core.pcoa import sketch_width
from repro_torch.dist import pairwise_condensed, pairwise_distances

CPU = "cpu"


def _table(seed, n, d, nonneg=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    if nonneg:
        x = np.abs(x)
    x[rng.random(size=x.shape) < 0.2] = 0.0
    return x.astype(np.float32)


def _operators(seed, n, d, metric, block):
    x = _table(seed, n, d)
    jop = JaxCondensedOperator.from_production(
        jax_condensed(x, metric, block=block), block=block)
    op = CondensedCenteredGramOperator.from_production(
        pairwise_condensed(x, metric, block=block, device=CPU), block=block)
    return x, jop, op


@pytest.mark.parametrize("metric,n", [("euclidean", 37), ("braycurtis", 50)])
def test_matvec_trace_square_match_reference(metric, n):
    x, jop, op = _operators(6, n, 8, metric, block=16)
    v = _table(7, n, 3, nonneg=False)
    np.testing.assert_allclose(op.matvec(torch.from_numpy(v)).numpy(),
                               np.asarray(jop.matvec(jnp.asarray(v))),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(op.matvec(torch.from_numpy(v[:, 0])).numpy(),
                               np.asarray(jop.matvec(jnp.asarray(v[:, 0]))),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(op.trace()), float(jop.trace()),
                               rtol=1e-5)
    np.testing.assert_allclose(op.to_square().numpy(),
                               np.asarray(jop.to_square()), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(op.row_panel(5, 9).numpy(),
                               np.asarray(jop.row_panel(5, 9)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(op.materialize().numpy(),
                               np.asarray(jop.materialize()), rtol=2e-4,
                               atol=2e-4)


def test_matches_square_operator():
    """The condensed-backed operator is the same linear map as the
    square-backed one over the same distances."""
    x = _table(8, 41, 6)
    op_c = CondensedCenteredGramOperator.from_production(
        pairwise_condensed(x, "euclidean", block=16, device=CPU), block=16)
    op_s = CenteredGramOperator.from_distance(
        pairwise_distances(x, "euclidean", block=16, device=CPU))
    v = torch.from_numpy(_table(9, 41, 4, nonneg=False))
    np.testing.assert_allclose(op_c.matvec(v).numpy(), op_s.matvec(v).numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(op_c.trace()), float(op_s.trace()),
                               rtol=1e-5)


def test_rejects_overflow_n():
    with pytest.raises(ValueError, match="int32"):
        CondensedCenteredGramOperator(torch.zeros(3), torch.zeros(50000),
                                      torch.tensor(0.0), 50000)


@pytest.mark.parametrize("n,dims", [(48, 4), (90, 6)])
def test_operator_only_pcoa_matches_reference(n, dims):
    x, jop, op = _operators(n, n, 7, "braycurtis", block=16)
    want = jax_pcoa(None, dimensions=dims, operator=jop)
    omega = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(42), (n, sketch_width(dims, n)))))
    got = pcoa(None, dimensions=dims, operator=op, omega=omega, device=CPU)
    assert got.coordinates.shape == (n, dims) and got.method == "fsvd"
    np.testing.assert_allclose(got.eigenvalues.numpy(),
                               np.asarray(want.eigenvalues), rtol=1e-4)
    np.testing.assert_allclose(got.proportion_explained.numpy(),
                               np.asarray(want.proportion_explained),
                               rtol=1e-4)
    # and the operator-only solve agrees with the square path's eigh oracle
    dm = DistanceMatrix(op.to_square(), device=CPU)
    eigh = pcoa(dm, dimensions=dims, method="eigh", device=CPU)
    np.testing.assert_allclose(got.eigenvalues[:2].numpy(),
                               eigh.eigenvalues[:2].numpy(), rtol=1e-3)


def test_operator_only_refusals():
    """dm=None is the fully matrix-free entry, and only that."""
    _, _, op = _operators(19, 16, 5, "euclidean", block=8)
    r = pcoa(None, dimensions=3, operator=op, device=CPU)
    assert r.coordinates.shape == (16, 3) and r.key == 42
    with pytest.raises(ValueError, match="matrix-free"):
        pcoa(None, dimensions=3, method="eigh", operator=op, device=CPU)
    with pytest.raises(ValueError, match="matrix-free"):
        pcoa(None, dimensions=3, materialize=True, operator=op, device=CPU)
    with pytest.raises(ValueError, match="prebuilt operator"):
        pcoa(None, dimensions=3, device=CPU)
    dm = DistanceMatrix(op.to_square(), device=CPU)
    with pytest.raises(ValueError, match="matrix-free fsvd"):
        pcoa(dm, dimensions=3, method="eigh", operator=op, device=CPU)
