"""Port parity: the two-pass centering kernels' plain version.

The same numpy matrices go through the reference's Pallas kernel pair
(``center_distance_matrix_pallas``, in interpret mode on the CPU) and the
port's wrapper on a CPU tensor (pass 1, the fixed-order finish and pass 2
in plain PyTorch). Tolerances are the reference's own
(``tests/test_kernels.py``): rtol 2e-4 / atol 2e-4 in fp32; in bf16, within
0.05·scale of the fp32 oracle with correlation > 0.999, since centering
subtracts near-equal magnitudes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.core.centering import (center_distance_matrix_blocked as
                                  jax_blocked)
from repro.kernels.center_ops import center_distance_matrix_pallas
from repro.kernels.center_ref import center_distance_matrix_ref as jax_ref
from repro_torch.core.centering import (center_distance_matrix,
                                        center_distance_matrix_blocked,
                                        center_distance_matrix_ref)
from repro_torch.kernels.center_ops import (center_block_op,
                                            center_distance_matrix_op,
                                            center_means_op,
                                            center_row_sums_op)
from repro_torch.kernels.center_ref import (center_finish_ref,
                                            center_pass1_ref,
                                            center_pass2_ref)


def _matrix(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 8))
    d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))
    d = (0.5 * (d + d.T)).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    return d


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("n", [16, 64, 77, 128, 200])
def test_plain_two_pass_matches_pallas(n):
    d = _matrix(n, n)
    want = center_distance_matrix_pallas(jnp.asarray(d), block_m=32,
                                         block_n=32)
    _close(center_distance_matrix_op(torch.from_numpy(d)), want)


@pytest.mark.parametrize("bm,bn", [(8, 8), (16, 32), (64, 16)])
def test_plain_two_pass_matches_pallas_block_shapes(bm, bn):
    d = _matrix(64, 1)
    want = center_distance_matrix_pallas(jnp.asarray(d), block_m=bm,
                                         block_n=bn)
    _close(center_distance_matrix_op(torch.from_numpy(d)), want)


def test_plain_two_pass_bf16():
    d = _matrix(64, 2)
    got = center_distance_matrix_op(torch.from_numpy(d).bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(jax_ref(jnp.asarray(d)))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 0.05 * scale
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999
    # and the reference's own bf16 kernel lands as close
    ref_bf16 = np.asarray(center_distance_matrix_pallas(
        jnp.asarray(d).astype(jnp.bfloat16), block_m=32, block_n=32),
        np.float32)
    assert np.abs(got - want).max() <= max(np.abs(ref_bf16 - want).max(),
                                           0.01 * scale)


@pytest.mark.parametrize("n,block", [(100, 32), (64, 16), (37, 1024)])
def test_blocked_and_ref_match_reference(n, block):
    d = _matrix(n, n + 3)
    t = torch.from_numpy(d)
    _close(center_distance_matrix_blocked(t, block=block),
           jax_blocked(jnp.asarray(d), block=block))
    _close(center_distance_matrix_ref(t), jax_ref(jnp.asarray(d)))
    _close(center_distance_matrix(t), jax_ref(jnp.asarray(d)))


def test_passes_compose_to_the_oracle():
    d = torch.from_numpy(_matrix(45, 4))
    row_sums = center_pass1_ref(d)
    np.testing.assert_allclose(row_sums.numpy(),
                               (-0.5 * d.double() ** 2).sum(1).numpy(),
                               rtol=1e-6)
    row_means, global_mean = center_finish_ref(row_sums)
    assert global_mean.shape == (1,) and global_mean.dtype == torch.float32
    np.testing.assert_allclose(float(global_mean),
                               float(row_sums.double().sum()) / 45 ** 2,
                               rtol=1e-7)
    _close(center_pass2_ref(d, row_means, global_mean),
           center_distance_matrix_ref(d))


def test_wrapper_checks_operand():
    d = torch.from_numpy(_matrix(10, 5))
    with pytest.raises(ValueError, match="square"):
        center_distance_matrix_op(d[:, :9])
    with pytest.raises(TypeError, match="bfloat16"):
        center_distance_matrix_op(d.double())
    with pytest.raises(ValueError, match="contiguous"):
        center_distance_matrix_op(d.T)


@pytest.mark.parametrize("pr,pc", [(1, 1), (2, 2), (4, 2), (2, 4), (3, 1)])
def test_block_mode_is_the_square_sliced(pr, pc):
    """The kernels' block mode (the distributed centering's): pass 1 of the
    (r, c) blocks summed over a block row gives the square's row sums, and
    pass 2 of a block, given its row and column means, is the square's F
    sliced, bit for bit."""
    n = 96
    d = torch.from_numpy(_matrix(n, pr * 10 + pc))
    row_sums = center_pass1_ref(d)
    row_means, gm = center_finish_ref(row_sums)
    f = center_pass2_ref(d, row_means, gm)
    r, c = n // pr, n // pc
    for i0 in range(0, n, r):
        parts = [center_row_sums_op(d[i0:i0 + r, j0:j0 + c].contiguous())
                 for j0 in range(0, n, c)]
        _close(torch.stack(parts).sum(0), row_sums[i0:i0 + r])
        for j0 in range(0, n, c):
            block = d[i0:i0 + r, j0:j0 + c].contiguous()
            got = center_block_op(block, row_means[i0:i0 + r].contiguous(),
                                  row_means[j0:j0 + c].contiguous(), gm)
            assert torch.equal(got, f[i0:i0 + r, j0:j0 + c])
    # the finish on the gathered row sums is the square's
    assert all(torch.equal(a, b) for a, b in zip(center_means_op(row_sums),
                                                  (row_means, gm)))
    assert torch.equal(center_pass2_ref(d, row_means, gm, row_means), f)


def test_block_wrappers_check_operands():
    d = torch.from_numpy(_matrix(12, 3))[:6, :4].contiguous()
    rm, cm, gm = torch.zeros(6), torch.zeros(4), torch.zeros(1)
    with pytest.raises(ValueError, match="col_means"):
        center_block_op(d, rm, torch.zeros(6), gm)
    with pytest.raises(TypeError, match="bfloat16"):
        center_row_sums_op(d.double())
    with pytest.raises(ValueError, match="contiguous"):
        center_block_op(d.T, cm, rm, gm)
