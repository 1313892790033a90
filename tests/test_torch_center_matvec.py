"""Port parity: the center-matvec kernel's plain version and the operator.

The same numpy inputs go through the reference (the Pallas kernel in
interpret mode, and ``CenteredGramOperator.matvec``) and the port on the
CPU. Tolerance rtol 1e-5 / atol 1e-5·max(scale, 1), the reference's own
(``tests/test_kernels.py``): the two sum the n-long products in another
order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.centering import center_distance_matrix as jax_center
from repro.core.operators import CenteredGramOperator as JaxOperator
from repro.kernels.center_matvec_ops import center_matvec_pallas
from repro_torch.core.centering import (center_distance_matrix,
                                        center_distance_matrix_ref)
from repro_torch.core.operators import CenteredGramOperator
from repro_torch.kernels.center_matvec_ops import center_matvec_op


def _inputs(n, k, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 6))
    d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))
    d = (0.5 * (d + d.T)).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    x = rng.normal(size=(n, k)).astype(np.float32)
    return d, x


def _close(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * max(scale, 1.0))


@pytest.mark.parametrize("n,k", [(16, 4), (77, 7), (128, 20), (200, 3),
                                 (64, 40)])
def test_plain_version_matches_pallas_kernel(n, k):
    d, x = _inputs(n, k, seed=n)
    jop = JaxOperator.from_distance(jnp.asarray(d))
    want = center_matvec_pallas(jnp.asarray(d), jnp.asarray(x), jop.row_means,
                                jop.global_mean, block_m=32, block_n=32,
                                interpret=True)
    op = CenteredGramOperator.from_distance(torch.from_numpy(d))
    got = center_matvec_op(op.d, torch.from_numpy(x), op.row_means,
                           op.global_mean)
    _close(got, want)


@pytest.mark.parametrize("n,k", [(33, 5), (101, 14)])
def test_operator_matches_reference_operator(n, k):
    d, x = _inputs(n, k, seed=n + 1)
    jop = JaxOperator.from_distance(jnp.asarray(d), block=32)
    op = CenteredGramOperator.from_distance(torch.from_numpy(d))
    np.testing.assert_allclose(op.row_means.numpy(), np.asarray(jop.row_means),
                               rtol=1e-6)
    _close(op.matvec(torch.from_numpy(x)), jop.matvec(jnp.asarray(x)))
    _close(op.matvec(torch.from_numpy(x[:, 0])), jop.matvec(jnp.asarray(
        x[:, 0])))
    assert abs(float(op.trace()) - float(jop.trace())) <= \
        1e-5 * abs(float(jop.trace()))
    _close(op.materialize(), jop.materialize())


def test_centering_matches_reference():
    d, _ = _inputs(57, 1, seed=3)
    want = np.asarray(jax_center(jnp.asarray(d)))
    _close(center_distance_matrix(torch.from_numpy(d)), want)
    _close(center_distance_matrix_ref(torch.from_numpy(d)), want)


def test_wrapper_checks_operands():
    d, x = _inputs(10, 3, seed=4)
    op = CenteredGramOperator.from_distance(torch.from_numpy(d))
    with pytest.raises(ValueError, match="x must be"):
        center_matvec_op(op.d, torch.zeros(9, 3), op.row_means,
                         op.global_mean)
    with pytest.raises(TypeError, match="float32"):
        center_matvec_op(op.d.double(), torch.from_numpy(x), op.row_means,
                         op.global_mean)
    with pytest.raises(ValueError, match="contiguous"):
        center_matvec_op(op.d, torch.zeros(3, 10).T, op.row_means,
                         op.global_mean)
