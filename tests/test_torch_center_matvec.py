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

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.core.centering import center_distance_matrix as jax_center
from repro.core.operators import CenteredGramOperator as JaxOperator
from repro.kernels.center_matvec_ops import center_matvec_pallas
from repro_torch.core.centering import (center_distance_matrix,
                                        center_distance_matrix_ref)
from repro_torch.core.operators import CenteredGramOperator
from repro_torch.kernels import _build
from repro_torch.kernels.center_matvec import (RESIDENT_CLUSTERS, SM_COUNT,
                                               STAGE_COLS, STRIP_ROWS,
                                               SWEEP_SPLITS, sweep_split)
from repro_torch.kernels.center_matvec_ops import (block_product_op,
                                                   center_matvec_op)
from repro_torch.kernels.center_matvec_ref import (center_corrections,
                                                   center_matvec_block_ref,
                                                   center_matvec_ref)


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
                                 (64, 40), (96, 128), (70, 130)])
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


# --- 3xTF32 tolerance study --------------------------------------------
# The card's kernel (csrc/center_matvec.cu) multiplies on the tensor cores
# in 3xTF32. The study below runs its arithmetic here, in torch, in its
# order: E = -1/2 d d in fp32; each of E and X split into hi = tf32(v) and
# lo = tf32(v - hi), rounded to nearest (ties away from zero) on the
# mantissa; for every stage of 32 columns, from zero, per 8-column k-step
# the MMAs e_lo x_hi, e_hi x_lo, e_hi x_hi, each adding its 8 exact products
# to the fp32 stage sum with one rounding; the stage sum added to the fp32
# running sum of its cluster rank (rank q of a split s sums stages
# [q T / s, (q + 1) T / s) of the T from zero); the ranks' sums added in
# rank order; then the rank-1 corrections in fp32. (The tensor cores'
# adder may round otherwise inside an MMA; the emulation models one
# rounding to nearest an MMA.) It must stay within the shipped tolerance of
# the fp64 plain version; plain TF32 (e_hi x_hi alone) must not.

STUDY_N = 2048
STAGE = 32      # D columns a stage of the kernel
KSTEP = 8       # columns an MMA


def _tf32(v):
    """fp32 rounded to tf32's 10 mantissa bits, to nearest, ties away from
    zero (``cvt.rna.tf32.f32``)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(v):
    hi = _tf32(v)
    return hi, _tf32(v - hi)


def _emulate_kernel(d, x, row_means, global_mean, products=3, split=1):
    """The kernel's result, computed in its order (``products=3``), or
    with plain TF32 products (``products=1``), each strip's sweep split
    over a cluster of ``split`` ranks."""
    n, k = x.shape
    colsum, corr = center_corrections(x, row_means, global_mean)
    e_hi, e_lo = _split(-0.5 * d * d)
    x_hi, x_lo = _split(x)
    terms = [(e_lo, x_hi), (e_hi, x_lo), (e_hi, x_hi)][3 - products:]
    stages = -(-n // STAGE)
    ranks = []
    for q in range(split):
        acc = torch.zeros((n, k), dtype=torch.float32)
        for t in range(q * stages // split, (q + 1) * stages // split):
            j0 = t * STAGE
            step = torch.zeros((n, k), dtype=torch.float32)
            for s in range(j0, min(j0 + STAGE, n), KSTEP):
                cols = slice(s, min(s + KSTEP, n))
                for a, b in terms:
                    step = (step.double()
                            + a[:, cols].double() @ b[cols].double()).float()
            acc = acc + step
        ranks.append(acc)
    acc = ranks[0]
    for part in ranks[1:]:
        acc = acc + part
    return acc + (corr[None, :] - row_means[:, None] * colsum[None, :])


def _study_inputs(k):
    rng = np.random.default_rng(k)
    pts = rng.normal(size=(STUDY_N, 6))
    sq = (pts ** 2).sum(1)
    d = np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2 * pts @ pts.T, 0))
    d = (0.5 * (d + d.T)).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    x = rng.normal(size=(STUDY_N, k)).astype(np.float32)
    d, x = torch.from_numpy(d), torch.from_numpy(x)
    row_means = -0.5 * torch.mean(d * d, dim=1)
    return d, x, row_means, torch.mean(row_means)


def _use_of_tolerance(got, want):
    """max |got - want| / (atol + rtol·|want|) with the shipped rtol 1e-5,
    atol 1e-5·max(scale, 1): at most 1 passes."""
    got, want = got.double(), want.double()
    atol = 1e-5 * max(float(want.abs().max()), 1.0)
    return float(((got - want).abs() / (atol + 1e-5 * want.abs())).max())


def test_tf32_rounding_matches_the_hardware_rule():
    v = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20,
                      -(1.0 + 3 * 2.0 ** -11), 1.0 + 2.0 ** -12],
                     dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -(1.0 + 2.0 ** -9), 1.0], dtype=torch.float32)
    assert torch.equal(_tf32(v), want)
    hi, lo = _split(torch.tensor([np.float32(np.pi)]))
    assert float(hi + lo) == pytest.approx(float(np.float32(np.pi)),
                                          rel=2.0 ** -21)


@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("k", [20, 128])
def test_3xtf32_emulation_is_within_the_shipped_tolerance(k, split):
    d, x, row_means, gm = _study_inputs(k)
    want = center_matvec_ref(d, x, row_means, gm)
    use = _use_of_tolerance(_emulate_kernel(d, x, row_means, gm,
                                            split=split), want)
    print(f"3xTF32 n={STUDY_N} k={k} split={split}: {use:.4f} of the "
          f"tolerance (margin {1 / use:.1f}x)")
    assert use <= 1.0


def test_split_emulation_sums_in_another_order():
    """A split sums the unsplit kernel's terms in another order: close to
    split = 1, not bitwise equal."""
    d, x, row_means, gm = _study_inputs(20)
    one = _emulate_kernel(d[:256, :256], x[:256], row_means[:256], gm)
    two = _emulate_kernel(d[:256, :256], x[:256], row_means[:256], gm,
                          split=2)
    assert not torch.equal(one, two)
    _close(two, one)


@pytest.mark.parametrize("k", [20, 128])
def test_sweep_split_keeps_the_main_path_square_unsplit(k):
    assert sweep_split(16384, 16384, k) == 1


@pytest.mark.parametrize("rows,cols,k,want", [
    (8192, 8192, 20, 2), (8192, 8192, 128, 2), (8320, 4096, 20, 2),
    (8448, 8448, 20, 2), (8449, 8449, 20, 1), (4096, 4096, 20, 2),
    (3840, 3840, 128, 4), (129, 40, 7, 2), (7, 3, 3, 1), (1000, 700, 20, 8),
    (1920, 1920, 64, 4), (1920, 1920, 48, 8), (2048, 2048, 20, 4)])
def test_sweep_split_fills_the_card_within_the_stages(rows, cols, k, want):
    """At least 2 at a 2 x 2 mesh's (8192, 8192) block; never more strips
    than the card holds clusters of s at once (30 of 4, 15 of 8) nor ranks
    than stages; 8 only where the seven slots of the cluster's sum fit the
    shared memory the sweep leaves (k <= 48)."""
    assert sweep_split(rows, cols, k) == want


def test_sweep_split_bounds_hold_everywhere(monkeypatch):
    """A function of its arguments alone: it asks no card and no library
    (both refuse here), so the bits never depend on the card."""
    def refuse(*args, **kwargs):
        raise AssertionError("sweep_split asked the card")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(torch.cuda, "get_device_properties", refuse)
    for rows in (1, 127, 129, 1000, 2048, 4096, 8192, 8448, 8449, 16384,
                 20000):
        for cols in (1, 31, 33, 40, 64, 100, 4096, 16384):
            for k in (1, 7, 20, 45, 48, 49, 64, 65, 96, 97, 128):
                s = sweep_split(rows, cols, k)
                strips = -(-rows // STRIP_ROWS)
                assert s in SWEEP_SPLITS
                assert s == 1 or strips * s <= SM_COUNT
                assert s == 1 or strips <= RESIDENT_CLUSTERS[s]
                assert s <= max(1, -(-cols // STAGE_COLS))


@pytest.mark.parametrize("k", [20, 128])
def test_plain_tf32_would_miss_the_tolerance(k):
    d, x, row_means, gm = _study_inputs(k)
    want = center_matvec_ref(d, x, row_means, gm)
    use = _use_of_tolerance(_emulate_kernel(d, x, row_means, gm, products=1),
                            want)
    print(f"plain TF32 n={STUDY_N} k={k}: {use:.4f} of the tolerance")
    assert use > 1.0


@pytest.mark.parametrize("pr,pc,k", [(1, 1, 4), (2, 2, 5), (4, 2, 20),
                                     (1, 3, 7), (2, 4, 130)])
def test_block_mode_sums_to_the_square(pr, pc, k):
    """The kernel's block mode (the distributed matvec's): the products of
    a block row's (r, c) blocks with their slices of X, summed, plus the
    corrections, are the square's F@X; with zero means and corrections a
    block gives its E_blk@X_col alone (``block_product_op``)."""
    n = 96
    d, x = map(torch.from_numpy, _inputs(n, k, pr * 10 + pc))
    row_means = -0.5 * torch.mean(d * d, dim=1)
    gm = torch.mean(row_means)
    colsum, corr = center_corrections(x, row_means, gm)
    want = center_matvec_ref(d, x, row_means, gm)
    assert torch.equal(center_matvec_block_ref(d, x, row_means, colsum, corr),
                       want)
    r, c = n // pr, n // pc
    zeros_r, zeros_k = torch.zeros(r), torch.zeros(k)
    for i0 in range(0, n, r):
        parts = []
        for j0 in range(0, n, c):
            block = d[i0:i0 + r, j0:j0 + c].contiguous()
            xs = x[j0:j0 + c].contiguous()
            parts.append(block_product_op(block, xs))
            assert torch.equal(parts[-1], center_matvec_block_ref(
                block, xs, zeros_r, zeros_k, zeros_k))
        got = torch.stack(parts).sum(0) + (
            corr[None, :] - row_means[i0:i0 + r, None] * colsum[None, :])
        _close(got, want[i0:i0 + r])
    with pytest.raises(ValueError, match="x must be"):
        block_product_op(d[:r, :c].contiguous(), x[:c - 1])
