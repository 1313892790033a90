"""The condensed centred-Gram product's op, its plain version and the
kernel's geometry, on the CPU.

The CPU route of ``CondensedCenteredGramOperator.matvec`` is held bit for
bit against the strip loop the operator ran before the kernel existed
(copied below as it was), on the contiguous X the operator now hands its
op. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``); here a torch emulation of its stage copies
(the triangle index of every tile it reads, element for element) and of
its summation order (the stage sweep, the warps' tree, the cluster's ranks)
is held against the plain version at the card tests' tolerance, rtol 1e-5 /
atol 1e-5·max(scale, 1), ``center_matvec``'s: the two sum in another order.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro_torch.core import CondensedCenteredGramOperator
from repro_torch.core.distance_matrix import (MAX_TRIANGLE_N, condensed_index,
                                              condensed_to_square)
from repro_torch.dist import pairwise_condensed
from repro_torch.kernels import _build
from repro_torch.kernels.center_matvec import SM_COUNT
from repro_torch.kernels.center_matvec_ref import center_corrections
from repro_torch.kernels.condensed_matvec import (GROUP_COLS, KMAX, MAX_N,
                                                  STAGE_COLS, STRIP_ROWS,
                                                  SWEEP_SPLITS, blocks_per_sm,
                                                  condensed_matvec,
                                                  condensed_matvec_cost,
                                                  sweep_split, width)
from repro_torch.kernels.condensed_matvec_ops import condensed_matvec_op
from repro_torch.kernels.condensed_matvec_ref import condensed_matvec_ref


def _old_strip_loop(op, x):
    """``CondensedCenteredGramOperator.matvec`` before the kernel, verbatim
    but for ``self``."""
    colsum = torch.sum(x, dim=0)                     # 1ᵀX   (k,)
    corr = op.global_mean * colsum - op.row_means @ x
    b = max(min(op.block, op.n), 1)
    out = torch.empty((op.n, x.shape[1]), dtype=x.dtype, device=x.device)
    for i0 in range(0, op.n, b):
        bi = min(b, op.n - i0)
        if op.dc.shape[0] == 0:
            rows = torch.zeros((bi, op.n), dtype=op.dc.dtype)
        else:
            r = torch.arange(i0, i0 + bi, dtype=torch.int32)[:, None]
            c = torch.arange(op.n, dtype=torch.int32)[None, :]
            on_diag = r == c
            k = condensed_index(r, c, op.n)
            rows = torch.where(on_diag, 0.0,
                               op.dc[torch.where(on_diag, 0, k).long()])
        e_rows = -0.5 * rows * rows
        out[i0:i0 + bi] = (e_rows @ x
                           - op.row_means[i0:i0 + bi, None]
                           * colsum[None, :] + corr[None, :])
    return out


def _operator(n, d=9, seed=0, block=256):
    rng = np.random.default_rng(seed)
    x = rng.random((n, d)).astype(np.float32)
    x[rng.random((n, d)) < 0.4] = 0.0
    x[:, 0] += 0.1                          # no empty row
    return CondensedCenteredGramOperator.from_production(
        pairwise_condensed(x, device="cpu"), block=block)


def _block(n, k, seed):
    return torch.randn((n, k), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("n,k,block", [
    (2, 1, 256), (3, 20, 256), (50, 3, 16), (127, 20, 256), (128, 20, 256),
    (129, 20, 256), (300, 21, 64), (600, 128, 256), (257, 129, 100)])
def test_cpu_route_is_the_old_strip_loop_bit_for_bit(n, k, block):
    op = _operator(n, seed=n, block=block)
    x = _block(n, k, n + k)
    want = _old_strip_loop(op, x)
    assert torch.equal(op.matvec(x), want)
    # the operator hands the op a contiguous X, as the square operator does
    assert torch.equal(op.matvec(x[:, 0]),
                       _old_strip_loop(op, x[:, :1].contiguous())[:, 0])
    assert torch.equal(condensed_matvec_op(op.dc, x, op.row_means,
                                           op.global_mean, n, block=block),
                       want)


@pytest.mark.parametrize("n", [0, 1])
@pytest.mark.parametrize("k", [1, 3])
def test_n_at_most_one_gives_zeros(n, k):
    dc = torch.zeros((0,))
    row_means = torch.zeros((n,))
    gm = torch.tensor(0.0)
    x = _block(n, k, 1)
    got = condensed_matvec_op(dc, x, row_means, gm, n)
    assert got.shape == (n, k) and torch.equal(got, torch.zeros((n, k)))
    op = CondensedCenteredGramOperator(dc, row_means, gm, n)
    assert torch.equal(op.matvec(x), torch.zeros((n, k)))
    assert float(op.trace()) == 0.0


def _operands(n=30, k=4):
    op = _operator(n, seed=5)
    return op.dc, _block(n, k, 2), op.row_means, op.global_mean


@pytest.mark.parametrize("fault,match", [
    ("x_rows", r"x must be \(30, k\)"),
    ("x_vector", r"x must be \(30, k\)"),
    ("dc_length", "dc must have shape"),
    ("x_dtype", "x must be torch.float32"),
    ("dc_dtype", "dc must be torch.float32"),
    ("row_means_shape", "row_means must have shape"),
    ("global_mean_shape", "global_mean must have shape"),
    ("x_strided", "x must be contiguous"),
    ("device", "different devices")])
def test_op_refuses_bad_operands(fault, match):
    dc, x, row_means, gm = _operands()
    if fault == "x_rows":
        x = x[:29]
    elif fault == "x_vector":
        x = x[:, 0]
    elif fault == "dc_length":
        dc = dc[:-1]
    elif fault == "x_dtype":
        x = x.double()
    elif fault == "dc_dtype":
        dc = dc.double()
    elif fault == "row_means_shape":
        row_means = row_means[:-1]
    elif fault == "global_mean_shape":
        gm = gm.reshape(1)
    elif fault == "x_strided":
        x = _block(4, 30, 2).T
    elif fault == "device":
        x = x.to("meta")
    with pytest.raises((ValueError, TypeError), match=match):
        condensed_matvec_op(dc, x, row_means, gm, 30)


@pytest.mark.parametrize("n,k,want", [
    (4743, 20, 4), (4743, 1, 4), (4743, 21, 2), (4743, 128, 1),
    (16384, 20, 1), (16384, 128, 1), (2, 1, 1), (33, 20, 2), (300, 20, 4),
    (8450, 20, 2)])
def test_sweep_split_fills_the_card_from_the_shape_alone(n, k, want):
    assert sweep_split(n, k) == want


def test_sweep_split_rules_hold_at_every_shape():
    for n in (2, 3, 31, 32, 33, 64, 65, 127, 128, 129, 1000, 4743, 8192,
              16385, MAX_N):
        for k in (1, 4, 5, 20, 21, 24, 32, 33, 64, 127, 128):
            s = sweep_split(n, k)
            blocks = -(-n // STRIP_ROWS) * -(-k // GROUP_COLS)
            assert s in SWEEP_SPLITS and s <= -(-n // STAGE_COLS)
            assert s == 1 or blocks * s <= SM_COUNT * blocks_per_sm(k)
            assert width(k) % 4 == 0 and min(k, GROUP_COLS) <= width(k) \
                <= GROUP_COLS
    assert MAX_N == MAX_TRIANGLE_N


def test_cost_counts_each_pair_twice():
    n, k = 4743, 20
    m = n * (n - 1) // 2
    nbytes, ops = condensed_matvec_cost(n, k)
    assert nbytes == 4.0 * (2 * m + 75 * (n * k + 2 * k) + n) + 4.0 * n * k
    assert ops == 2.0 * n * n * k + n * n
    assert condensed_matvec_cost(n, 128)[1] == 2.0 * n * n * 128 + 4 * n * n


@pytest.mark.parametrize("fault,match", [
    ("n_one", "2 <= n"), ("n_past_max", "2 <= n"), ("k_zero", "1 <= k"),
    ("k_wide", "1 <= k"), ("x_rows", "x must have shape"),
    ("colsum_dtype", "colsum must be torch.float32"),
    ("x_strided", "x must be contiguous"), ("cpu", "CUDA device")])
def test_launch_refuses_what_the_kernel_does_not_take(fault, match):
    """Refused before the library is built or a pointer is taken."""
    n, k = 30, 4
    dc, x, row_means, _ = _operands(n, k)
    colsum, corr = torch.zeros(k), torch.zeros(k)
    if fault == "n_one":
        n = 1
    elif fault == "n_past_max":
        n = MAX_N + 1
    elif fault == "k_zero":
        x = torch.zeros((n, 0))
    elif fault == "k_wide":
        x = torch.zeros((n, KMAX + 1))
    elif fault == "x_rows":
        x = x[:-1]
    elif fault == "colsum_dtype":
        colsum = colsum.double()
    elif fault == "x_strided":
        x = _block(k, n, 3).T
    before = dict(_build.launches)
    with pytest.raises((ValueError, TypeError), match=match):
        condensed_matvec(dc, x, row_means, colsum, corr, n)
    assert _build.launches == before


def test_int32_index_is_exact_up_to_max_n():
    a = np.arange(MAX_N, dtype=np.int64)
    assert int((a * (2 * MAX_N - a - 3)).max()) < 2**31
    assert int((a * (2 * MAX_N - a - 1)).max()) < 2**31


# --------------------------------------------------------------------------
# An emulation of the card kernel: its copies and its order of summation
# --------------------------------------------------------------------------
def _run_start(a, n):
    """``run_start`` of ``csrc/condensed_matvec.cu``: pair (a, b) at
    run_start(a) + b."""
    return a * (2 * n - a - 3) // 2 - 1


def _stage_tile(dc, n, i0, j0):
    """What ``issue_stage`` copies for stage (i0, j0): D[i0:i0+128,
    j0:j0+32], by the branch the kernel takes for that tile."""
    i = torch.arange(i0, i0 + STRIP_ROWS)[:, None]
    j = torch.arange(j0, j0 + STAGE_COLS)[None, :]
    if j0 >= i0 + STRIP_ROWS:                   # above: row runs
        valid = (i < n) & (j < n)
        at = _run_start(i, n) + j
    elif j0 + STAGE_COLS <= i0:                 # below: column runs
        valid = (i < n).expand(-1, STAGE_COLS)
        at = _run_start(j, n) + i
    else:                                       # across: element by element
        valid = (i < n) & (j < n) & (i != j)
        at = torch.where(i < j, _run_start(i, n) + j, _run_start(j, n) + i)
    return torch.where(valid, dc[torch.where(valid, at, 0)], 0.0)


def _emulated_kernel(dc, x, row_means, colsum, corr, n):
    """The kernel's sums in its order, in fp32 (its FMAs rounded twice):
    each strip's cluster ranks sweep their stages, a warp 4 columns a
    stage, the warps meet in the fixed tree, the ranks in rank order."""
    k = x.shape[1]
    split = sweep_split(n, k)
    stages = -(-n // STAGE_COLS)
    xp = torch.zeros((stages * STAGE_COLS, k))
    xp[:n] = x
    out = torch.empty((n, k))
    for i0 in range(0, n, STRIP_ROWS):
        ranks = []
        for part in range(split):
            warps = torch.zeros((8, STRIP_ROWS, k))
            for t in range(part * stages // split,
                           (part + 1) * stages // split):
                tile = _stage_tile(dc, n, i0, t * STAGE_COLS)
                xt = xp[t * STAGE_COLS:(t + 1) * STAGE_COLS]
                for q in range(STAGE_COLS // 8):
                    c = torch.arange(8) + 8 * q
                    e = tile[:, c].T ** 2
                    warps = warps + e[:, :, None] * xt[c][:, None, :]
            for half in (4, 2, 1):
                warps = warps[:half] + warps[half:2 * half]
            ranks.append(warps[0])
        acc = ranks[0]
        for more in ranks[1:]:
            acc = acc + more
        rows = slice(i0, min(i0 + STRIP_ROWS, n))
        out[rows] = -0.5 * acc[:rows.stop - i0] + (
            corr[None, :] - row_means[rows, None] * colsum[None, :])
    return out


@pytest.mark.parametrize("n", [2, 3, 40, 129, 300, 1000])
def test_stage_copies_read_the_square(n):
    """Every tile the kernel copies is the square's, zero on the diagonal
    and past n, whichever branch copies it."""
    op = _operator(n, seed=n + 1)
    sq = torch.zeros((-(-n // STRIP_ROWS) * STRIP_ROWS + STAGE_COLS,) * 2)
    sq[:n, :n] = condensed_to_square(op.dc, n)
    for i0 in range(0, n, STRIP_ROWS):
        for j0 in range(0, n, STAGE_COLS):
            assert torch.equal(_stage_tile(op.dc, n, i0, j0),
                               sq[i0:i0 + STRIP_ROWS, j0:j0 + STAGE_COLS]), \
                (i0, j0)


@pytest.mark.parametrize("n,k", [(2, 1), (3, 20), (129, 20), (300, 20),
                                 (1000, 20), (300, 33)])
def test_kernel_order_is_within_the_card_tolerance(n, k):
    """The emulated kernel against the plain version at the card tests'
    tolerance; its columns do not depend on the columns beside them."""
    op = _operator(n, seed=n + 2)
    x = _block(n, k, n)
    colsum, corr = center_corrections(x, op.row_means, op.global_mean)
    got = _emulated_kernel(op.dc, x, op.row_means, colsum, corr, n)
    want = condensed_matvec_ref(op.dc, x, op.row_means, op.global_mean, n)
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * max(scale, 1.0))
    other = x.clone()
    other[:, 1:] = _block(n, k - 1, n + 1) if k > 1 else other[:, 1:]
    alone = _emulated_kernel(op.dc, other, op.row_means, colsum, corr, n)
    assert torch.equal(alone[:, 0], got[:, 0])
