"""The port's CUDA kernels on the card, each against its plain version.

Every test here needs a CUDA card and skips without one (the ``cuda``
fixture). On the card, where JAX is absent, run them without the suite's
conftest: ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_cuda.py``.
The kernels are built from ``src/repro_torch/csrc`` on first use.

Tolerances: ``symhollow`` is exact (it computes booleans);
``center_matvec`` and ``condensed_matvec`` rtol 1e-5 / atol
1e-5·max(scale, 1) and
``permute_reduce`` rtol 1e-5 / atol 1e-5, the reference's own kernel
tolerances (``tests/test_kernels.py``, ``tests/test_permute_reduce.py``):
both sum in another order than their plain versions. ``pairwise_panel``
rtol 1e-5 / atol 1e-5 (``tests/test_dist.py``), and so is
``pairwise_sparse_panel`` against its plain version on signed floats
(another order again); on integer counts, where every partial sum is exact,
it is held bit for bit against ``pairwise_panel``; the ``center`` pair
rtol 2e-4 / atol 2e-4 in fp32, within 0.05·scale with correlation > 0.999
in bf16 (``tests/test_kernels.py``), for the same reason. ``mantel_corr``
rtol 1e-5 / atol 1e-5·max(scale, 1) on its raw sums and rtol 1e-4 /
atol 1e-5 on the Pearson r (``tests/test_kernels.py``); the statistics
battery card against CPU: statistic to 1e-5 (PERMDISP 1e-4·max(|s|, 1)),
p-values equal (``tests/test_stats.py``); the operator-form PERMANOVA, whose
production sums in another order on the card, to 1e-4·|s|
(``tests/test_dist.py``). ``rmsnorm`` against its plain version: rtol
1e-5 / atol 1e-6 in fp32 (another summation order, ``rsqrtf``), at most one
bf16 unit in the last place in bf16 (one rounding of values that differ in
fp32 by an ulp or two), and two launches bitwise equal (a fixed-order sum);
the LM smoke path card against CPU in fp32: logits to rtol 1e-5 /
atol 1e-5·max(scale, 1), the products summing in another order on the card.
The ``rmsnorm`` backward against its plain version given the forward's
inverse RMS: dx and dw in fp32 at rtol 1e-5 / atol 1e-5·max(scale, 1) (its
fp32 dw partials are summed in another order), in bf16 within 2 bf16 units
in the last place, and two launches bitwise equal; through autograd on the
card, x's and w's gradients are the kernel's. Three smoke train steps, card
against CPU from the same state (a resumed run's moments): losses at rtol
1e-5, parameters and moments at rtol 1e-5 / atol 1e-5·max(scale, 1). The
MoE FFN at the smoke widths in fp32, card against CPU: the routing (each
pair's expert, slot and keep) equal, y and aux to rtol 1e-5 / atol 1e-5;
the int8 ring cache: int8 values within 1 unit (K/V differ by rounding, so
a value at a half step may round the other way), scales to rtol 1e-6, slot
positions equal, outputs to 1e-4 (a unit's flip moves a product by a
quantization step, ~1e-3 of the values); one smoke decode step of
granite-moe, phi-3-vision, mamba2 (a block norm and the SSD's gated norm
a layer) and recurrentgemma launches ``rmsnorm`` exactly 2·layers + 1
times. The SSD, RG-LRU and enc-dec smokes served card against CPU in fp32:
logits to rtol 1e-5 / atol 1e-5·max(scale, 1), each recurrent state and
cross K/V likewise; the SSD at chunk 256, whose decay's exponent passes
88.7 above the diagonal: output card against CPU to rtol 1e-5 / atol
1e-5·max(scale, 1) and every gradient finite. fp32 products against fp64 within 1e-5 of the largest (TF32 stays
off); granite-moe's MoE layer at full width in fp32, a token alone
against its chunk of 528: the same experts, y within 1e-5·max(scale, 1).
The sharded train, prefill and decode steps on a 1 x 1 NCCL mesh against
the single-process steps (qwen3-8b's and granite-moe's smokes): losses,
``rmsnorm`` launches, parameters and logits bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro_torch import models
from repro_torch.api import ExecConfig, Workspace
from repro_torch.core import (CenteredGramOperator,
                              CondensedCenteredGramOperator,
                              center_distance_matrix,
                              center_distance_matrix_distributed,
                              centered_gram_matvec_distributed, mantel, pcoa,
                              random_distance_matrix)
from repro_torch.core.mantel import MantelStatistic, mantel_null_distributed
from repro_torch.core.distance_matrix import (DistanceMatrix,
                                              condensed_to_square,
                                              triangle_coords)
from repro_torch.dist import METRICS, pairwise_condensed, pairwise_distances
from repro_torch.kernels import _build
from repro_torch.kernels.center import (center_finish, center_pass1,
                                        center_pass2)
from repro_torch.kernels.center_ops import center_distance_matrix_op
from repro_torch.kernels.center_ref import (center_distance_matrix_ref,
                                            center_pass1_ref,
                                            center_pass2_ref,
                                            center_two_pass_ref)
from repro_torch.kernels.center_matvec import (RESIDENT_CLUSTERS,
                                               SWEEP_SPLITS, center_matvec,
                                               resident_clusters,
                                               sweep_split)
from repro_torch.kernels.center_matvec_ops import (block_product_op,
                                                   center_matvec_op)
from repro_torch.kernels.center_matvec_ref import (center_matvec_block_ref,
                                                   center_matvec_ref)
from repro_torch.kernels.condensed_matvec import (STRIP_ROWS,
                                                  resident_clusters as
                                                  condensed_clusters,
                                                  sweep_split as
                                                  condensed_split)
from repro_torch.kernels.condensed_matvec_ops import condensed_matvec_op
from repro_torch.kernels.condensed_matvec_ref import condensed_matvec_ref
from repro_torch.kernels.inverse_orders import (MAX_N, cluster_size,
                                                inverse_orders,
                                                inverse_orders_kernel,
                                                inverse_orders_plain)
from repro_torch.kernels.mantel_corr import (mantel_corr, mantel_corr_finish,
                                             mantel_corr_partials)
from repro_torch.kernels.mantel_corr_ops import mantel_corr_op
from repro_torch.kernels.mantel_corr_ref import (mantel_corr_plain,
                                                 mantel_corr_rows)
from repro_torch.launch.mesh import check_device, full_tensor, make_host_mesh
from repro_torch.dist import driver
from repro_torch.kernels.pairwise import (pairwise_panel,
                                          pairwise_sparse_panel, sparse_rows)
from repro_torch.kernels.pairwise_ops import (pairwise_panel_op,
                                              row_nonzeros, row_support)
from repro_torch.kernels.pairwise_ref import (pairwise_panel_ref,
                                              pairwise_sparse_panel_ref)
from repro_torch.configs import get_arch
from repro_torch.kernels.permute_reduce import (permute_reduce_finish,
                                                permute_reduce_partials)
from repro_torch.kernels.permute_reduce_ops import permute_reduce
from repro_torch.kernels.permute_reduce_ref import permute_reduce_ref
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_backward
from repro_torch.kernels.rmsnorm_ops import rmsnorm_op
from repro_torch.kernels.rmsnorm_ref import (bf16_ulp_distance,
                                             rmsnorm_backward_plain,
                                             rmsnorm_plain)
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train import build_train_step_fn, init_train_state
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.transformer import (Transformer, decode_step,
                                            init_params, prefill)
from repro_torch.runtime.serve import build_decode_fn, build_prefill_fn
from repro_torch.kernels.symhollow_ops import is_symmetric_and_hollow_op
from repro_torch.kernels.symhollow_ref import is_symmetric_and_hollow_ref
from repro_torch.stats import (PermanovaOperatorStatistic, anosim,
                               partial_mantel, permanova, permdisp)
from repro_torch.stats.engine import (encode_grouping, hoist_and_observe,
                                      null_distribution,
                                      null_distribution_distributed,
                                      permutation_orders, permutation_test)


@pytest.fixture
def cuda():
    """The card; decided when a test runs, never at import, so every
    worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _matrix(n, seed, cuda):
    return random_distance_matrix(seed, n, device=cuda).data


def test_kernels_build_for_sm90a(cuda):
    lib = _build.library()
    assert lib.repro_error_string(0).decode() == "no error"
    assert "sm_90a" in _build.build_log()


@pytest.mark.parametrize("n", [1, 2, 33, 100, 1000])
@pytest.mark.parametrize("case", ["valid", "asym", "nonhollow", "nan_off",
                                  "nan_diag", "negzero_diag"])
def test_symhollow_matches_plain(cuda, n, case):
    mat = _matrix(n, n, cuda).clone()
    i, j = (n - 1) // 3, n - 1
    if case == "asym" and n > 1:
        mat[i, j] += 1.0
    elif case == "nonhollow":
        mat[j, j] = 0.5
    elif case == "nan_off" and n > 1:
        mat[i, j] = float("nan")
        mat[j, i] = float("nan")
    elif case == "nan_diag":
        mat[j, j] = float("nan")
    elif case == "negzero_diag":
        mat[j, j] = -0.0
    got = is_symmetric_and_hollow_op(mat)
    assert got == is_symmetric_and_hollow_ref(mat.cpu())


def _center_matvec_operands(n, k, cuda):
    d = _matrix(n, n + 1, cuda)
    gen = torch.Generator().manual_seed(n)
    x = torch.randn((n, k), generator=gen).to(cuda)
    row_means = -0.5 * torch.mean(d * d, dim=1)
    return d, x, row_means, torch.mean(row_means)


@pytest.mark.parametrize("n,k", [
    (1, 1), (7, 3), (100, 20), (1000, 20), (257, 32), (130, 45),
    (1, 128), (7, 129), (257, 64), (257, 128), (1001, 1), (1001, 20),
    (1001, 64), (1001, 128), (1001, 129), (1001, 200), (1000, 128),
    (130, 200)])
def test_center_matvec_matches_plain(cuda, n, k):
    """Ragged n (4-byte copies of D) and k (4-byte copies of X, k padded to
    the MMA width in the kernel); up to 128 columns in one launch, slabs of
    128 above."""
    d, x, row_means, gm = _center_matvec_operands(n, k, cuda)
    _build.reset_launches()
    got = center_matvec_op(d, x, row_means, gm)
    assert _build.launches["center_matvec"] == -(-k // 128)
    want = center_matvec_ref(d, x, row_means, gm)
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * max(scale, 1.0))


def test_center_matvec_is_bitwise_reproducible(cuda):
    d, x, row_means, gm = _center_matvec_operands(1001, 128, cuda)
    a = center_matvec_op(d, x, row_means, gm)
    b = center_matvec_op(d, x, row_means, gm)
    assert torch.equal(a, b)


def _condensed_operands(n, k, cuda, seed=0):
    """Bray–Curtis-like condensed distances in [0, 1), their operator
    means, and an (n, k) block, on the card."""
    gen = torch.Generator().manual_seed(seed + n)
    dc = torch.rand((n * (n - 1) // 2,), generator=gen)
    sq = condensed_to_square(dc, n)
    row_means = -0.5 * torch.mean(sq * sq, dim=1)
    x = torch.randn((n, k), generator=gen)
    return (dc.to(cuda), x.to(cuda), row_means.to(cuda),
            torch.mean(row_means).to(cuda))


@pytest.mark.parametrize("k", [1, 20, 128, 129])
@pytest.mark.parametrize("n", [2, 3, 127, 128, 129, 300, 1000])
def test_condensed_matvec_matches_plain(cuda, n, k):
    """Ragged n (strips, stages and the diagonal's tiles) and k (the
    widths, 32-column groups, and slabs of 128 above): one launch a slab,
    against the strip loop on the CPU."""
    dc, x, row_means, gm = _condensed_operands(n, k, cuda)
    _build.reset_launches()
    got = condensed_matvec_op(dc, x, row_means, gm, n)
    assert _build.launches["condensed_matvec"] == -(-k // 128)
    want = condensed_matvec_ref(dc.cpu(), x.cpu(), row_means.cpu(), gm.cpu(),
                                n)
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * max(scale, 1.0))


@pytest.mark.parametrize("n", [0, 1])
def test_condensed_matvec_without_pairs_is_zeros_and_no_launch(cuda, n):
    dc = torch.zeros((0,), device=cuda)
    x = torch.randn((n, 20), device=cuda)
    _build.reset_launches()
    got = condensed_matvec_op(dc, x, torch.zeros((n,), device=cuda),
                              torch.tensor(0.0, device=cuda), n)
    assert _build.launches["condensed_matvec"] == 0
    assert got.shape == (n, 20) and not bool(got.any())


@pytest.mark.parametrize("n,k", [(1000, 20), (4743, 20), (1001, 128)])
def test_condensed_matvec_is_bitwise_reproducible(cuda, n, k):
    dc, x, row_means, gm = _condensed_operands(n, k, cuda, seed=1)
    a = condensed_matvec_op(dc, x, row_means, gm, n)
    b = condensed_matvec_op(dc, x, row_means, gm, n)
    assert torch.equal(a, b)


@pytest.mark.parametrize("n", [700, 4743])
def test_condensed_matvec_column_is_independent_of_its_batch(cuda, n):
    """A column's bits are the same wherever it sits in a product of one
    width: a tile of 5 orders padded as ``fixed_products`` pads it (its
    rows repeated) against the full tile, and a column moved to another
    position among other columns."""
    dc, x, row_means, gm = _condensed_operands(n, 128, cuda, seed=2)
    full = condensed_matvec_op(dc, x, row_means, gm, n)
    padded = x.clone()
    padded[:, 20:] = x[:, torch.arange(20, 128, device=cuda) % 20]
    got = condensed_matvec_op(dc, padded, row_means, gm, n)
    assert torch.equal(got[:, :20], full[:, :20])
    moved = torch.randn((n, 128), device=cuda)
    moved[:, 77] = x[:, 3]
    assert torch.equal(condensed_matvec_op(dc, moved, row_means, gm, n)[:, 77],
                       full[:, 3])


def test_condensed_operator_permanova_rows_do_not_depend_on_b(cuda):
    """The operator-form PERMANOVA over a feature production: a tile of 5
    orders (padded to 32 by ``fixed_products``) gives bitwise the first 5
    statistics of the full tile."""
    n = 700
    op = CondensedCenteredGramOperator.from_production(
        pairwise_condensed(_abundances(n, 40, 17), device=cuda))
    stat = PermanovaOperatorStatistic(
        op, torch.from_numpy(np.arange(n) % 4).to(cuda), n, 4)
    inv = stat.hoist()
    orders = permutation_orders(8, 32, n, cuda)
    assert torch.equal(stat.per_batch(inv, orders[:5]),
                       stat.per_batch(inv, orders)[:5])


@pytest.mark.parametrize("n,k", [(4743, 1), (4743, 20), (4743, 21),
                                 (4743, 128), (16384, 20), (300, 20)])
def test_condensed_matvec_clusters_run_in_one_wave(cuda, n, k):
    """The split chosen from the shape alone keeps every block resident
    at once on this card (where the strips do not fill it alone)."""
    split = condensed_split(n, k)
    if split > 1:
        blocks = -(-n // STRIP_ROWS) * -(-k // 32)
        assert condensed_clusters(k, split) >= blocks


def _bits(t):
    return t.cpu().numpy().tobytes()


def _tiles_around(target, n, seed, cuda):
    """Tiles of 32 order rows with ``target`` beside three sets of partners
    and at positions 0, 17 and 31 (the walk pairs 0 with 1, 17 with 16 and
    31 with 30): ``(position, orders)``."""
    for partners in range(3):
        others = permutation_orders(seed + partners, 31, n, cuda)
        for pos in (0, 17, 31):
            yield pos, torch.cat([others[:pos], target, others[pos:]])


@pytest.mark.parametrize("n", [700, 1500])
@pytest.mark.parametrize("rows", [1, 2])
def test_permute_reduce_rows_are_independent_of_tile_mates(cuda, n, rows):
    """One permutation's fp64 partials (each block's sum) and fp32 outputs
    are bitwise the same whatever the other rows of its tile and wherever
    it stands in it: a request's draws do not depend on its tile-mates."""
    xc = random_distance_matrix(n + 5, n, device=cuda).condensed_form()
    ys = torch.randn((rows, xc.numel()), generator=torch.Generator()
                     .manual_seed(n)).to(cuda)
    target = permutation_orders(n + 6, 1, n, cuda)
    partials, outputs = set(), set()
    for pos, orders in _tiles_around(target, n, n + 7, cuda):
        inv, orders16 = inverse_orders(orders)
        part = permute_reduce_partials(xc, ys, inv, orders16)
        partials.add(_bits(part[:, :, pos]))
        outputs.add(_bits(permute_reduce_finish(part)[:, pos]))
        outputs.add(_bits(permute_reduce(xc, ys, orders)[:, pos]))
    assert len(partials) == 1 and len(outputs) == 1


@pytest.mark.parametrize("n", [700, 1500])
def test_mantel_corr_rows_are_independent_of_tile_mates(cuda, n):
    x = _matrix(n, n + 8, cuda)
    yhat = torch.randn((n, n), generator=torch.Generator()
                       .manual_seed(n)).to(cuda)
    target = permutation_orders(n + 9, 1, n, cuda)
    partials, outputs = set(), set()
    for pos, orders in _tiles_around(target, n, n + 10, cuda):
        inv, orders16 = inverse_orders(orders)
        part = mantel_corr_partials(x, yhat, inv, orders16)
        partials.add(_bits(part[:, pos]))
        outputs.add(_bits(mantel_corr_finish(part)[pos]))
        outputs.add(_bits(mantel_corr(x, yhat, orders)[pos]))
    assert len(partials) == 1 and len(outputs) == 1


@pytest.mark.parametrize("n,perms,rows", [
    (2, 3, 1), (33, 5, 1), (17, 7, 2), (1000, 32, 1), (1000, 32, 2),
    (40, 3, 6), (1001, 32, 1), (1001, 32, 2), (1002, 70, 2), (999, 129, 1)])
def test_permute_reduce_matches_plain(cuda, n, perms, rows):
    """Ragged n (1001, 1002, 999: the runs start at every alignment) and
    slabs of rows and of permutations (S·B above 128)."""
    m = n * (n - 1) // 2
    xc = random_distance_matrix(n, n, device=cuda).condensed_form()
    gen = torch.Generator().manual_seed(n)
    ys = torch.randn((rows, m), generator=gen).to(cuda)
    orders = permutation_orders(n + 1, perms, n, cuda)
    got = permute_reduce(xc, ys, orders)
    ii, jj = triangle_coords(n, device=cuda)
    want = permute_reduce_ref(xc, ys, ii, jj, orders, n, 65536)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_permute_reduce_is_bitwise_reproducible(cuda):
    n = 700
    xc = random_distance_matrix(1, n, device=cuda).condensed_form()
    ys = torch.randn((1, xc.numel()), generator=torch.Generator()
                     .manual_seed(2)).to(cuda)
    orders = permutation_orders(3, 32, n, cuda)
    a = permute_reduce(xc, ys, orders)
    b = permute_reduce(xc, ys, orders)
    assert torch.equal(a, b)


def test_permute_reduce_takes_no_triangle_map_or_chunk_on_the_card(cuda):
    n = 50
    xc = random_distance_matrix(2, n, device=cuda).condensed_form()
    ys = torch.ones((1, xc.numel()), device=cuda)
    orders = permutation_orders(5, 4, n, cuda)
    ii, jj = triangle_coords(n, device=cuda)
    with pytest.raises(ValueError, match="no triangle map"):
        permute_reduce(xc, ys, orders, ii, jj)
    with pytest.raises(ValueError, match="no chunk"):
        permute_reduce(xc, ys, orders, chunk=64)


@pytest.mark.parametrize("perms", [1, 2, 32, 128])
@pytest.mark.parametrize("n", [1, 2, 7, 1001, 16384, MAX_N])
def test_inverse_orders_matches_plain(cuda, n, perms):
    """One cluster launch a tile, bitwise the plain version, up to the
    16-bit limit n = 65536 (values 0..65535)."""
    orders = permutation_orders(n, perms, n, cuda)
    _build.reset_launches()
    inv, orders16 = inverse_orders(orders)
    assert _build.launches["inverse_orders"] == 1
    want_inv, want16, is_perm = inverse_orders_plain(orders.cpu())
    assert bool(is_perm.all())
    assert torch.equal(inv.cpu(), want_inv)
    assert torch.equal(orders16.cpu(), want16)


@pytest.mark.parametrize("fault", ["repeat", "negative", "too_large"])
def test_non_permutation_orders_are_refused(cuda, fault):
    n = 257
    orders = permutation_orders(6, 8, n, cuda)
    c = cluster_size(8, n)
    if fault == "repeat":
        # positions 10 and 200 lie in different ranks of the row's cluster,
        # so two blocks store into one slot through distributed shared memory
        assert c > 1 and 10 * c // n != 200 * c // n
        orders[5, 10] = orders[5, 200]
    elif fault == "negative":
        orders[5, 10] = -1
    else:
        orders[5, 10] = n
    _, _, flags = inverse_orders_kernel(orders)
    assert flags.cpu().tolist() == [1] * 5 + [0] + [1] * 2
    d = random_distance_matrix(7, n, device=cuda)
    xc = d.condensed_form()
    with pytest.raises(ValueError, match="order row 5 is not a permutation"):
        permute_reduce(xc, xc[None], orders)
    with pytest.raises(ValueError, match="order row 5 is not a permutation"):
        mantel_corr(d.data, d.data, orders)
    with pytest.raises(ValueError, match="order row 5 is not a permutation"):
        permute_reduce(xc.cpu(), xc.cpu()[None], orders.cpu())


@pytest.mark.parametrize("n,perms", [(16384, 32), (MAX_N, 32)])
def test_a_repeat_across_cluster_ranks_is_refused_at_the_paths_tile(cuda, n,
                                                                    perms):
    """At the main path's tile (a cluster of 4 a row) and at the 16-bit
    limit: a value repeated from rank 0's share into rank 2's, and an
    out-of-range value in the last rank's, mark only their rows."""
    orders = permutation_orders(n, perms, n, cuda)
    c = cluster_size(perms, n)
    assert c >= 4
    orders[3, 10] = orders[3, n // 2 + 7]
    orders[30, n - 1] = n
    _, _, flags = inverse_orders_kernel(orders)
    assert flags.cpu().tolist() == [0 if b in (3, 30) else 1
                                    for b in range(perms)]


def test_launch_counts_follow_the_main_path(cuda):
    dm = random_distance_matrix(5, 300, dim=6, device=cuda)
    _build.reset_launches()
    DistanceMatrix(dm.data, device=cuda)
    pcoa(dm, dimensions=4, device=cuda)
    mantel(dm, dm, permutations=40, device=cuda)
    assert _build.launches == {"symhollow": 1, "center_matvec": 4,
                               "condensed_matvec": 0,
                               "inverse_orders": 2, "permute_reduce": 2,
                               "permute_reduce_finish": 2,
                               "within_sums": 0, "within_sums_finish": 0,
                               "pairwise_panel": 0,
                               "pairwise_sparse_panel": 0, "center_pass1": 0,
                               "center_finish": 0, "center_pass2": 0,
                               "mantel_corr": 0, "mantel_corr_finish": 0,
                               "rmsnorm": 0, "rmsnorm_bwd": 0}


def test_main_path_card_matches_cpu(cuda):
    """The same inputs through the card and the CPU give the same answers."""
    n = 200
    d = random_distance_matrix(9, n, dim=5, device="cpu").data
    omega = torch.randn((n, 14), generator=torch.Generator().manual_seed(3))
    orders = permutation_orders(4, 49, n)
    noise = torch.triu(0.01 * torch.rand((n, n), generator=torch.Generator()
                                         .manual_seed(5)), 1)
    results = {}
    for dev in ("cpu", cuda):
        dm = DistanceMatrix(d, device=dev)
        dm2 = DistanceMatrix(d + noise + noise.T, device=dev)
        r = pcoa(dm, dimensions=4, omega=omega, device=dev)
        results[str(dev)] = (r.eigenvalues.cpu(),
                             mantel(dm, dm2, permutations=49, orders=orders,
                                    device=dev))
    (ev_cpu, m_cpu), (ev_gpu, m_gpu) = results["cpu"], results["cuda"]
    np.testing.assert_allclose(ev_gpu.numpy(), ev_cpu.numpy(), rtol=1e-4)
    assert m_gpu[1] == m_cpu[1]
    assert abs(m_gpu[0] - m_cpu[0]) <= 1e-5


def _abundances(n, d, seed, zero_rows=()):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((n, d), generator=gen)
    x[torch.rand((n, d), generator=gen) < 0.6] = 0.0
    x[list(zero_rows)] = 0.0
    return x


@pytest.mark.parametrize("metric", sorted(METRICS))
@pytest.mark.parametrize("bm,n,d", [(1, 1, 1), (10, 30, 11), (64, 64, 32),
                                    (70, 130, 33), (256, 1000, 300)])
def test_pairwise_panel_matches_plain(cuda, metric, bm, n, d):
    x = _abundances(n, d, bm + n + d, zero_rows=(0, n - 1)).to(cuda)
    xi = x[:bm]
    got = pairwise_panel_op(xi, x, metric)
    want = pairwise_panel_ref(xi, x, METRICS[metric])
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


def _support(x):
    counts = row_nonzeros(x)
    return row_support(x, counts, int(counts.max()))


@pytest.mark.parametrize("n,d,share,heavy,rows", [
    (300, 777, 0.02, 0, 4), (129, 4000, 0.05, 0, 4),
    (200, 40000, 0.001, 8000, 2), (150, 40000, 0.001, 20000, 1)])
def test_pairwise_sparse_panel_matches_plain(cuda, n, d, share, heavy, rows):
    """Signed floats, an all-zero row and pair; 4, 2 and 1 held rows a
    block (row 5 made ``heavy`` nonzeros long)."""
    gen = torch.Generator().manual_seed(n + d)
    x = torch.randn((n, d), generator=gen)
    x[torch.rand((n, d), generator=gen) >= share] = 0.0
    x[5, :heavy] = torch.randn(heavy, generator=gen)
    x[[0, 2, n - 1]] = 0.0
    x = x.to(cuda)
    sup = _support(x)
    assert sparse_rows(d, sup.max_row) == rows
    for row0, bm in ((0, min(64, n)), (37, min(100, n - 37)), (n - 3, 3)):
        got = pairwise_sparse_panel(sup, row0, bm)
        want = pairwise_sparse_panel_ref(sup, row0, bm)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
        dense = pairwise_panel(x[row0:row0 + bm], x, METRICS["braycurtis"]
                               .kind)
        np.testing.assert_allclose(got.cpu().numpy(), dense.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(got, pairwise_sparse_panel(sup, row0, bm))
        diag = torch.arange(bm, device=cuda)
        assert bool((got[diag, row0 + diag] == 0).all())


def _hmp_counts(cuda, n=700, d=9000, seed=2**40 + 7):
    """The features cell's generator scaled down: its communities and
    rarefaction at n samples and d OTUs (about 1.3% nonzero at full d)."""
    import json
    from pathlib import Path
    from perfbench.inputs.rarefied_counts import make
    from perfbench.traffic import Plan
    root = Path(__file__).resolve().parents[1]
    config = json.loads((root / "perfbench" / "configs"
                         / "features-hmp-v35.json").read_text())
    config.update(n=n, d=d)
    return make(config, Plan({}, seed), cuda)["table"]


def test_pairwise_sparse_panel_is_the_dense_kernel_bitwise_on_counts(cuda):
    x = _hmp_counts(cuda)
    sup = _support(x)
    assert sup.nnz < 0.1 * x.numel()
    kind = METRICS["braycurtis"].kind
    for i0 in range(0, x.shape[0], 256):
        bm = min(256, x.shape[0] - i0)
        got = pairwise_sparse_panel(sup, i0, bm)
        assert torch.equal(got, pairwise_panel(x[i0:i0 + bm], x, kind)), i0
        assert torch.equal(got, pairwise_sparse_panel(sup, i0, bm)), i0


def test_sparse_production_launches_and_matches_the_dense_route(
        cuda, monkeypatch):
    """A production of counts below ``SPARSE_SHARE``: one sparse launch a
    panel and none of the dense kernel, its condensed vector and hoists bit
    for bit the dense route's."""
    x = _hmp_counts(cuda, n=600, d=20000, seed=11)
    _build.reset_launches()
    sparse = pairwise_condensed(x, device=cuda)
    assert {k: v for k, v in _build.launches.items() if v} == {
        "pairwise_sparse_panel": 3}
    monkeypatch.setattr(driver, "SPARSE_SHARE", 0.0)
    _build.reset_launches()
    dense = pairwise_condensed(x, device=cuda)
    assert {k: v for k, v in _build.launches.items() if v} == {
        "pairwise_panel": 3}
    for key in ("condensed", "row_means", "global_mean", "mean", "norm"):
        assert torch.equal(sparse[key], dense[key]), key


def test_pairwise_square_is_symmetric_hollow_and_validates(cuda):
    x = _abundances(300, 40, 3).to(cuda)
    for metric in sorted(METRICS):
        sq = pairwise_distances(x, metric, block=64, device=cuda)
        assert torch.equal(sq, sq.T), metric
        assert bool((torch.diagonal(sq) == 0).all()), metric
        DistanceMatrix(sq, device=cuda)


@pytest.mark.parametrize("n", [1, 7, 100, 1000, 1027])
def test_center_matches_plain(cuda, n):
    d = _matrix(n, n + 2, cuda)
    row_sums = center_pass1(d)
    np.testing.assert_allclose(row_sums.cpu().numpy(),
                               (-0.5 * d.double() ** 2).sum(1).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    row_means, global_mean = center_finish(row_sums)
    got = center_pass2(d, row_means, global_mean)
    for want in (center_two_pass_ref(d), center_distance_matrix_ref(d)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=2e-4, atol=2e-4)
    assert torch.equal(center_distance_matrix_op(d), got)   # deterministic


@pytest.mark.parametrize("n", [64, 1000, 1001])
def test_center_bf16_matches_plain(cuda, n):
    d = _matrix(n, n + 3, cuda)
    got = center_distance_matrix_op(d.bfloat16())
    assert got.dtype == torch.bfloat16
    got = got.float().cpu().numpy()
    want = center_distance_matrix_ref(d).cpu().numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 0.05 * scale
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


def test_feature_path_launches_and_matches_cpu(cuda):
    n, d = 300, 50
    x = _abundances(n, d, 8)
    y = x * torch.exp(0.3 * torch.randn((n, d), generator=torch.Generator()
                                        .manual_seed(9)))
    omega = torch.randn((n, 14), generator=torch.Generator().manual_seed(3))
    orders = permutation_orders(4, 49, n)
    results = {}
    for dev in ("cpu", cuda):
        config = ExecConfig(block=128, device=dev)
        _build.reset_launches()
        wx = Workspace.from_features(x, config=config)
        wy = Workspace.from_features(y, config=config)
        r = wx.pcoa(dimensions=4, omega=omega)
        m = wx.mantel(wy, 49, orders=orders)
        px = {"condensed": wx.condensed(),
              **wx.cache.get("dist_means", lambda: None)}
        results[str(dev)] = (px, r.eigenvalues.cpu(), m,
                             dict(_build.launches))
    (p_cpu, ev_cpu, m_cpu, l_cpu), (p_gpu, ev_gpu, m_gpu, l_gpu) = \
        results["cpu"], results["cuda"]
    assert set(l_cpu.values()) == {0}
    assert l_gpu["pairwise_panel"] == 6 and l_gpu["center_matvec"] == 0
    assert l_gpu["condensed_matvec"] == 4      # a launch a product of pcoa
    assert l_gpu["permute_reduce"] == 2
    for key in ("condensed", "row_means", "global_mean", "mean"):
        np.testing.assert_allclose(p_gpu[key].cpu().numpy(),
                                   p_cpu[key].numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ev_gpu.numpy(), ev_cpu.numpy(), rtol=1e-4)
    assert m_gpu.p_value == m_cpu.p_value
    assert abs(m_gpu.statistic - m_cpu.statistic) <= 1e-5


def test_materialized_solves_launch_the_center_pair(cuda):
    dm = random_distance_matrix(6, 257, dim=5, device=cuda)
    _build.reset_launches()
    r = pcoa(dm, dimensions=4, materialize=True, device=cuda)
    assert (_build.launches["center_pass1"], _build.launches["center_finish"],
            _build.launches["center_pass2"]) == (1, 1, 1)
    assert _build.launches["center_matvec"] == 0
    cpu = DistanceMatrix(dm.data.cpu(), device="cpu")
    want = pcoa(cpu, dimensions=4, method="eigh", device="cpu")
    np.testing.assert_allclose(r.eigenvalues.cpu().numpy(),
                               want.eigenvalues.numpy(), rtol=1e-4)


@pytest.mark.parametrize("n,perms", [(1, 1), (2, 3), (33, 5), (999, 27),
                                     (1000, 27), (1029, 8), (1001, 27),
                                     (1002, 27), (300, 130)])
def test_mantel_corr_matches_plain(cuda, n, perms):
    """The raw sums against the plain version, with a yhat that is neither
    symmetric nor hollow, at ragged n (n % 4 != 0 stages and streams
    scalars), and past 128 permutations (two launch pairs)."""
    x = _matrix(n, n + 3, cuda)
    gen = torch.Generator().manual_seed(n)
    yhat = torch.randn((n, n), generator=gen).to(cuda)
    orders = permutation_orders(n + 4, perms, n, cuda)
    _build.reset_launches()
    got = mantel_corr(x, yhat, orders)
    pairs = -(-perms // 128)
    assert (_build.launches["inverse_orders"], _build.launches["mantel_corr"],
            _build.launches["mantel_corr_finish"]) == (1, pairs, pairs)
    want = mantel_corr_plain(x, yhat, orders)
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * max(scale, 1.0))
    assert torch.equal(got, mantel_corr(x, yhat, orders))   # bitwise again


@pytest.mark.parametrize("method", ["mantel", "permanova", "anosim"])
def test_streamed_orders_are_the_whole_draw_on_the_card(cuda, monkeypatch,
                                                        method):
    """n = 512, K = 999, B = 32: a test that draws its orders a tile
    ahead, through the pinned buffers, gives the null and p-value of the
    same test given ``permutation_orders``, bit for bit, and leaves a
    generator key where the whole draw leaves it."""
    from repro_torch.stats import engine
    n, k = 512, 999
    x, y = _matrix(n, 1, cuda), _matrix(n, 2, cuda)
    grouping = np.arange(n) % 4
    nulls = []
    finish = engine.finish

    def keep(orig, permuted, *args, **kwargs):
        nulls.append(permuted.clone())
        return finish(orig, permuted, *args, **kwargs)

    monkeypatch.setattr(engine, "finish", keep)

    def run(**kw):
        ws = Workspace(x, config=ExecConfig(device=cuda, batch_size=32))
        call = {"mantel": lambda: ws.mantel(y, permutations=k, **kw),
                "permanova": lambda: ws.permanova(grouping, permutations=k,
                                                  **kw),
                "anosim": lambda: ws.anosim(grouping, permutations=k,
                                            **kw)}[method]
        return call(), nulls[-1]

    key, drawn = (torch.Generator().manual_seed(11) for _ in range(2))
    whole = permutation_orders(drawn, k, n, cuda)
    want, want_null = run(orders=whole)
    for got, got_null in (run(key=11), run(key=key)):
        assert got_null.shape == (k,) and torch.equal(got_null, want_null)
        assert got.p_value == want.p_value
        assert got.statistic == want.statistic
    assert torch.equal(key.get_state(), drawn.get_state())


def test_mantel_corr_op_matches_cpu_and_the_condensed_null(cuda):
    n, k = 1000, 54
    d = random_distance_matrix(7, n, device="cpu").data
    noise = torch.triu(0.05 * torch.rand((n, n), generator=torch.Generator()
                                         .manual_seed(8)), 1)
    y = d + noise + noise.T
    orders = permutation_orders(9, k, n)
    got = mantel_corr_op(d.to(cuda), y.to(cuda), orders.to(cuda),
                         perm_batch=27)
    want = mantel_corr_op(d, y, orders, perm_batch=27)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    draws = mantel(DistanceMatrix(d, device=cuda), DistanceMatrix(y, device=cuda),
                   permutations=k, orders=orders, device=cuda)
    ident = mantel_corr_op(d.to(cuda), y.to(cuda),
                           torch.arange(n, device=cuda)[None], perm_batch=1)
    assert abs(float(ident[0]) - draws[0]) <= 1e-5
    count = int(torch.sum(got.abs() >= abs(float(ident[0]))))
    assert float(np.float32(count + 1) / np.float32(k + 1)) == draws[1]


def test_battery_card_matches_cpu_with_its_launches(cuda):
    n, k = 300, 49
    d, y, z = (random_distance_matrix(s, n, dim=5, device="cpu")
               for s in (11, 12, 13))
    groups = np.arange(n) % 4
    codes = torch.from_numpy(encode_grouping(groups)[0])
    omega = torch.randn((n, 20), generator=torch.Generator().manual_seed(3))
    orders = permutation_orders(4, k, n)
    x = _abundances(n, 40, 14)
    tests = {
        "permanova": lambda dev, a, b, c: permanova(
            a, groups, k, orders=orders, device=dev),
        "anosim": lambda dev, a, b, c: anosim(
            a, groups, k, orders=orders, device=dev),
        "permdisp": lambda dev, a, b, c: permdisp(
            a, groups, k, dimensions=10, orders=orders, omega=omega,
            device=dev),
        "partial_mantel": lambda dev, a, b, c: partial_mantel(
            a, b, c, k, orders=orders, device=dev),
        "permanova_operator": lambda dev, a, b, c: permutation_test(
            PermanovaOperatorStatistic(
                CondensedCenteredGramOperator.from_production(
                    pairwise_condensed(x, device=dev)), codes, n, 4),
            k, orders=orders, device=dev),
    }
    want_launches = {
        "permanova": {"center_pass1": 1, "center_finish": 1,
                      "center_pass2": 1},
        "anosim": {"inverse_orders": 2, "within_sums": 2,
                   "within_sums_finish": 2},
        "permdisp": {"center_matvec": 4},
        "partial_mantel": {"inverse_orders": 2, "permute_reduce": 2,
                           "permute_reduce_finish": 2},
        # the observed statistic's product, then one a tile of 8 orders
        # (padded to 32 by fixed_products) x 4 groups: 128 columns, one
        # launch
        "permanova_operator": {"pairwise_panel": 2, "condensed_matvec": 8},
    }
    for name, run in tests.items():
        results = {}
        for dev in ("cpu", cuda):
            mats = [DistanceMatrix(m.data, device=dev) for m in (d, y, z)]
            _build.reset_launches()
            results[str(dev)] = run(dev, *mats)
            launches = {key: v for key, v in _build.launches.items() if v}
            if str(dev) == "cpu":
                assert launches == {}, name
            else:
                assert launches == want_launches[name], name
        cpu, gpu = results["cpu"], results["cuda"]
        # the reference's tolerances: PERMDISP tests/test_stats.py:221; the
        # operator form's production is summed in another order on each
        # device, held as tests/test_dist.py:214 holds it
        tol = {"permdisp": 1e-4 * max(abs(cpu.statistic), 1.0),
               "permanova_operator": 1e-4 * abs(cpu.statistic)}.get(name,
                                                                   1e-5)
        assert abs(gpu.statistic - cpu.statistic) <= tol, name
        assert gpu.p_value == cpu.p_value, name



def _session_battery(ws, y, z, groups, k, omega, orders):
    """The four grouping tests and the Mantel pair on one session."""
    return {"pcoa": ws.pcoa(dimensions=10, omega=omega),
            "permanova": ws.permanova(groups, k, orders=orders),
            "permdisp": ws.permdisp(groups, k, dimensions=10,
                                    orders=orders, omega=omega),
            "anosim": ws.anosim(groups, k, orders=orders),
            "mantel": ws.mantel(y, k, orders=orders),
            "partial_mantel": ws.partial_mantel(y, z, k, orders=orders)}


@pytest.mark.parametrize("n", [700, 1500])
def test_session_battery_is_bitwise_the_free_functions(cuda, n):
    """A square-backed session on the card gives bitwise the statistics
    and p-values of the free functions on the same orders and sketch;
    admission launches ``symhollow`` once a matrix, ``pcoa`` the four
    ``center_matvec`` launches, PERMDISP none, the center pair once,
    ANOSIM ``within_sums`` and the Mantel pair ``permute_reduce`` a tile."""
    k = 99
    d, y, z = (random_distance_matrix(s, n, dim=5, device=cuda).data
               for s in (21, 22, 23))
    groups = np.arange(n) % 4
    omega = torch.randn((n, 20), generator=torch.Generator().manual_seed(3))
    orders = permutation_orders(5, k, n)
    _build.reset_launches()
    ws = Workspace(d)
    wy, wz = Workspace(y), Workspace(z)
    assert _build.launches["symhollow"] == 3
    got = _session_battery(ws, wy, wz, groups, k, omega, orders)
    launches = {key: v for key, v in _build.launches.items() if v}
    tiles = -(-k // 32)
    assert launches == {"symhollow": 3, "center_matvec": 4,
                        "center_pass1": 1, "center_finish": 1,
                        "center_pass2": 1, "inverse_orders": 3 * tiles,
                        "permute_reduce": 2 * tiles,
                        "permute_reduce_finish": 2 * tiles,
                        "within_sums": tiles, "within_sums_finish": tiles}
    assert all(ws.cache.build_count(a) == 1 for a in
               ("operator", "gram", "condensed", "ranks", "moments",
                "coords"))
    x_dm, y_dm, z_dm = ws.dm, wy.dm, wz.dm
    want = {"permanova": permanova(x_dm, groups, k, orders=orders),
            "permdisp": permdisp(x_dm, groups, k, dimensions=10,
                                 orders=orders, omega=omega),
            "anosim": anosim(x_dm, groups, k, orders=orders),
            "partial_mantel": partial_mantel(x_dm, y_dm, z_dm, k,
                                             orders=orders)}
    for name, w in want.items():
        assert (got[name].statistic, got[name].p_value) == \
            (w.statistic, w.p_value), name
    stat, p, _ = mantel(x_dm, y_dm, k, orders=orders)
    assert (got["mantel"].statistic, got["mantel"].p_value) == (stat, p)
    assert torch.equal(got["pcoa"].eigenvalues, pcoa(
        x_dm, dimensions=10, omega=omega).eigenvalues)


@pytest.mark.parametrize("n", [700, 1500])
def test_session_admission_launches_symhollow_once(cuda, n):
    """A raw matrix is validated by one ``symhollow`` launch on the card;
    a validated DistanceMatrix is trusted; an invalid one is refused."""
    d = random_distance_matrix(24, n, dim=5, device=cuda)
    _build.reset_launches()
    ws = Workspace(d.data)
    assert _build.launches["symhollow"] == 1
    assert ws.data.device.type == "cuda" and ws.dm._validated
    Workspace(d)
    Workspace(d.data.cpu().numpy().astype(np.float64))
    assert _build.launches["symhollow"] == 2
    bad = d.data.clone()
    bad[0, 1] += 1.0
    with pytest.raises(ValueError, match="symmetric"):
        Workspace(bad)


@pytest.mark.parametrize("impl", ["ref", "fused"])
@pytest.mark.parametrize("n", [700, 1500])
def test_every_centering_impl_runs_the_center_pair(cuda, n, impl):
    """On the card each accepted ``centering_impl`` forms the Gower matrix
    with the ``center`` kernel pair, once a session, and the statistic
    agrees with the CPU session run by the same knob."""
    k = 49
    d = random_distance_matrix(25, n, dim=5, device=cuda).data
    groups = np.arange(n) % 3
    orders = permutation_orders(7, k, n)
    results = {}
    for dev in ("cpu", cuda):
        ws = Workspace(d, config=ExecConfig(device=dev, centering_impl=impl))
        _build.reset_launches()
        results[str(dev)] = ws.permanova(groups, k, orders=orders)
        ws.pcoa(dimensions=5, method="eigh")
        launches = {key: v for key, v in _build.launches.items() if v}
        assert launches == ({} if dev == "cpu" else {
            "center_pass1": 1, "center_finish": 1, "center_pass2": 1})
    _build.reset_launches()
    pcoa(DistanceMatrix(d, device=cuda), dimensions=5, method="eigh",
         centering_impl=impl)
    assert (_build.launches["center_pass1"], _build.launches["center_finish"],
            _build.launches["center_pass2"]) == (1, 1, 1)
    cpu, gpu = results["cpu"], results["cuda"]
    assert abs(gpu.statistic - cpu.statistic) <= 1e-5
    assert gpu.p_value == cpu.p_value


@pytest.mark.parametrize("n", [700, 1500])
def test_feature_session_builds_no_square(cuda, n):
    """A feature-backed session runs the battery on the card without an
    n×n buffer: no ``"square"`` key, PCoA and PERMANOVA through the
    condensed operator (``condensed_matvec``, no ``center_matvec``), and
    its answers match the same session on the CPU."""
    k = 49
    x = _abundances(n, 40, 31)
    y = _abundances(n, 40, 32)
    groups = np.arange(n) % 3
    omega = torch.randn((n, 13), generator=torch.Generator().manual_seed(4))
    orders = permutation_orders(6, k, n)
    results = {}
    for dev in ("cpu", cuda):
        config = ExecConfig(device=dev)
        _build.reset_launches()
        ws = Workspace.from_features(x, config=config)
        wy = Workspace.from_features(y, config=config)
        r = {"pcoa": ws.pcoa(dimensions=3, omega=omega),
             "mantel": ws.mantel(wy, k, orders=orders),
             "anosim": ws.anosim(groups, k, orders=orders),
             "permanova": ws.permanova(groups, k, orders=orders)}
        for w in (ws, wy):
            assert "square" not in w.cache and w._dm is None
            assert w.cache.build_count("square") == 0
        results[str(dev)] = (r, dict(_build.launches))
    (cpu, l_cpu), (gpu, l_gpu) = results["cpu"], results["cuda"]
    assert set(l_cpu.values()) == {0}
    panels = 2 * -(-n // 256)
    # pcoa's 4 products; PERMANOVA's observed product and one a tile of
    # 32 orders x 3 groups; Mantel's 2 tiles through permute_reduce,
    # ANOSIM's 2 through within_sums
    assert {key: v for key, v in l_gpu.items() if v} == {
        "pairwise_panel": panels, "condensed_matvec": 4 + 3,
        "inverse_orders": 4, "permute_reduce": 2, "permute_reduce_finish": 2,
        "within_sums": 2, "within_sums_finish": 2}
    np.testing.assert_allclose(gpu["pcoa"].eigenvalues.cpu().numpy(),
                               cpu["pcoa"].eigenvalues.numpy(), rtol=1e-4)
    for name in ("mantel", "anosim", "permanova"):
        tol = 1e-4 * abs(cpu[name].statistic) if name == "permanova" \
            else 1e-5
        assert abs(gpu[name].statistic - cpu[name].statistic) <= tol, name
        assert gpu[name].p_value == cpu[name].p_value, name


# the phase-2d shapes of chip_smoke.py, and edges of both kernels and paths
RMSNORM_CASES = [
    ((2048, 4096), torch.bfloat16, torch.bfloat16),
    ((2048, 4096), torch.float32, torch.float32),
    ((65536, 128), torch.bfloat16, torch.bfloat16),
    ((16384, 128), torch.bfloat16, torch.bfloat16),
    ((4, 4096), torch.bfloat16, torch.bfloat16),
    ((4, 1, 32, 128), torch.bfloat16, torch.bfloat16),
    ((4, 1, 8, 128), torch.bfloat16, torch.bfloat16),
    ((1000, 100), torch.float32, torch.float32),
    ((1, 1), torch.float32, torch.float32),
    ((9, 256), torch.bfloat16, torch.float32),
    ((3, 257), torch.bfloat16, torch.bfloat16),
    ((5, 264), torch.float32, torch.bfloat16),
    ((2, 4, 3, 128), torch.bfloat16, torch.bfloat16),
]


@pytest.mark.parametrize("shape,dtype,w_dtype", RMSNORM_CASES,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_rmsnorm_matches_plain(cuda, shape, dtype, w_dtype):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = (torch.randn(shape, generator=gen, device=cuda) * 3 + 0.5).to(dtype)
    w = (0.1 * torch.randn(shape[-1:], generator=gen, device=cuda)).to(
        w_dtype)
    _build.reset_launches()
    got = rmsnorm_op(x, w)
    again = rmsnorm_op(x, w)
    assert _build.launches["rmsnorm"] == 2
    want = rmsnorm_plain(x, w)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, again)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert int(bf16_ulp_distance(got, want).max()) <= 1


def test_lm_smoke_path_card_matches_cpu(cuda):
    cfg = get_arch("qwen3-8b", smoke=True)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if name.endswith(("norm.w", "q_norm", "k_norm", "ln1.w",
                              "ln2.w")):
                p.copy_(0.1 * torch.randn(p.shape, generator=torch.Generator(
                    ).manual_seed(len(name))))
    card = Transformer(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab, (2, 18),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        prefill = build_prefill_fn(cfg, max_len=20, device=dev)
        decode = build_decode_fn(cfg, device=dev)
        _build.reset_launches()
        logits, cache = prefill(model, {"tokens": tokens[:, :12]})
        steps = [logits]
        for t in range(12, 18):
            logits, cache = decode(model, tokens[:, t:t + 1], cache)
            steps.append(logits)
        launches = _build.launches["rmsnorm"]
        out[dev] = torch.cat(steps, dim=1).cpu()
        per_pass = cfg.n_layers * 4 + 1
        assert launches == (0 if dev == "cpu" else 7 * per_pass), dev
    scale = float(out["cpu"].abs().max())
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-5,
                               atol=1e-5 * max(scale, 1.0))


RMSNORM_BWD_CASES = [
    ((24576, 128), torch.bfloat16, torch.bfloat16),    # warp route, vector
    ((1024, 3072), torch.bfloat16, torch.bfloat16),    # block route, vector
    ((2048, 4096), torch.float32, torch.float32),
    ((1024, 3072), torch.bfloat16, torch.float32),
    ((1000, 100), torch.float32, torch.float32),       # warp route, scalar
    ((333, 3070), torch.bfloat16, torch.bfloat16),     # block route, scalar
    ((7, 256), torch.float32, torch.bfloat16),
    ((3, 257), torch.float32, torch.float32),
    ((1, 1), torch.float32, torch.float32),
    ((4, 2, 8, 128), torch.bfloat16, torch.bfloat16),
    ((77, 200), torch.bfloat16, torch.float32),        # warp route, a warp a row
    ((1024, 8192), torch.float32, torch.float32),      # ring route, 2 chunks a thread
    ((300, 6144), torch.bfloat16, torch.bfloat16),
    ((5, 2048), torch.bfloat16, torch.bfloat16),       # ring route, 5 blocks
    ((64, 1024), torch.bfloat16, torch.bfloat16),      # block route, vector
    ((16, 57344), torch.float32, torch.float32),       # MAX_BWD_D
    ((9, 57344), torch.bfloat16, torch.bfloat16),
]


def _hold_bwd(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert bool(torch.isfinite(got).all()), what
    if got.dtype == torch.float32:
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * max(scale, 1.0), msg=what)
    else:
        assert int(bf16_ulp_distance(got, want).max()) <= 2, what


@pytest.mark.parametrize("shape,dtype,w_dtype", RMSNORM_BWD_CASES,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_rmsnorm_backward_matches_plain(cuda, shape, dtype, w_dtype):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + 1)
    x = (torch.randn(shape, generator=gen, device=cuda) * 3 + 0.25).to(dtype)
    w = (0.1 * torch.randn(shape[-1:], generator=gen, device=cuda)).to(
        w_dtype)
    dy = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    d = shape[-1]
    x2, dy2 = x.reshape(-1, d), dy.reshape(-1, d)
    inv = torch.empty((x2.shape[0],), dtype=torch.float32, device=cuda)
    out = rmsnorm(x2, w, 1e-6, inv)
    assert torch.equal(out, rmsnorm(x2, w, 1e-6))   # inv changes nothing
    _build.reset_launches()
    dx, dw = rmsnorm_backward(x2, w, inv, dy2)
    again = rmsnorm_backward(x2, w, inv, dy2)
    assert _build.launches["rmsnorm_bwd"] == 2     # one launch a backward
    assert "rmsnorm_bwd_finish" not in _build.launches
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])
    want_dx, want_dw = rmsnorm_backward_plain(x2, w, dy2, inv=inv)
    _hold_bwd(dx, want_dx, "dx")
    _hold_bwd(dw, want_dw, "dw")


def test_rmsnorm_gradients_arrive_through_autograd_on_the_card(cuda):
    """Under autograd on a CUDA tensor the norm's output has a grad_fn (a
    bare launch would cut the gradient to x and give w none), and x's and
    w's gradients are the backward kernel's."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = (torch.randn((2, 8, 3072), generator=gen, device=cuda) * 2).to(
        torch.bfloat16).requires_grad_()
    w = (0.1 * torch.randn((3072,), generator=gen, device=cuda)).to(
        torch.bfloat16).requires_grad_()
    dy = torch.randn((2, 8, 3072), generator=gen, device=cuda).to(
        torch.bfloat16)
    _build.reset_launches()
    out = rmsnorm_op(x, w)
    assert out.grad_fn is not None
    out.backward(dy)
    assert _build.launches["rmsnorm"] == 1
    assert _build.launches["rmsnorm_bwd"] == 1
    assert x.grad is not None and w.grad is not None
    assert bool(w.grad.abs().sum() > 0)
    want_dx, want_dw = rmsnorm_backward_plain(x.detach(), w.detach(), dy)
    _hold_bwd(x.grad, want_dx, "x.grad")
    _hold_bwd(w.grad, want_dw, "w.grad")


@pytest.mark.parametrize("shape", [(1024, 3072), (24576, 128)])
def test_rmsnorm_backward_bits_do_not_depend_on_the_route(cuda, shape):
    """An input that is not 16-byte aligned takes the scalar route (the
    block route at d = 3072, the warp route's scalar columns at d = 128);
    each column's rows are summed in the same order, so dx and dw are the
    aligned call's bits."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = (torch.randn(shape, generator=gen, device=cuda) * 3).bfloat16()
    w = (0.1 * torch.randn(shape[-1:], generator=gen, device=cuda)).bfloat16()
    dy = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    inv = torch.empty((shape[0],), dtype=torch.float32, device=cuda)
    rmsnorm(x, w, 1e-6, inv)
    dx, dw = rmsnorm_backward(x, w, inv, dy)
    dx_u, dw_u = rmsnorm_backward(_misaligned(x), w, inv, _misaligned(dy))
    assert torch.equal(dx, dx_u) and torch.equal(dw, dw_u)


@pytest.mark.parametrize("name", ["llama3.2-3b", "qwen3-8b"])
def test_smoke_train_steps_card_match_cpu(cuda, name):
    cfg = dataclasses.replace(get_arch(name, smoke=True), microbatches=2)
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=100)
    cpu_model, cpu_opt = init_train_state(0, cfg, device="cpu")
    gen0 = torch.Generator().manual_seed(2)
    with torch.no_grad():                    # the norm weights act
        for pname, p in cpu_model.named_parameters():
            if p.ndim == 1:
                p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(
                    len(pname)))
        # a resumed run's moments: a first step from zero moments moves a
        # parameter whose gradient cancels to ~eps by a rounding-level
        # amount times up to 1 / (4 eps) (tests/test_torch_train.py)
        for key, scale in (("m", 1e-3), ("v", 2e-3)):
            for t in cpu_opt[key].values():
                t.normal_(0.0, scale, generator=gen0)
                if key == "v":
                    t.square_().add_(1e-6)
        cpu_opt["step"].fill_(10)
    card_model = Transformer(cfg, cuda)
    card_model.load_state_dict(cpu_model.state_dict())
    card_opt = {k: ({n: t.to(cuda) for n, t in v.items()}
                    if isinstance(v, dict) else v.to(cuda))
                for k, v in cpu_opt.items()}
    gen = torch.Generator().manual_seed(1)
    batches = [{"tokens": torch.randint(0, cfg.vocab, (4, 24), generator=gen),
                "targets": torch.randint(0, cfg.vocab, (4, 24),
                                         generator=gen)} for _ in range(3)]
    out = {}
    for dev, model, state in (("cpu", cpu_model, cpu_opt),
                              ("cuda", card_model, card_opt)):
        step = build_train_step_fn(cfg, opt, device=dev)
        _build.reset_launches()
        losses = []
        for batch in batches:
            model, state, metrics = step(model, state, batch)
            losses.append(float(metrics["loss"]))
        out[dev] = (losses, model, state, dict(_build.launches))
    norms = 2 * cfg.n_layers + 1 + (2 * cfg.n_layers if cfg.qk_norm else 0)
    launches = out["cuda"][3]
    assert launches["rmsnorm_bwd"] == 3 * 2 * norms       # steps x mbs
    assert launches["rmsnorm"] == 3 * 2 * (2 * norms - 1)  # + recomputed
    assert set(out["cpu"][3].values()) == {0}
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)

    def close(got, want):
        scale = float(want.abs().max())
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                   atol=1e-5 * max(scale, 1.0))
    for pname, p in out["cpu"][1].state_dict().items():
        close(out["cuda"][1].state_dict()[pname], p)
    for moment in ("m", "v"):
        for pname, t in out["cpu"][2][moment].items():
            close(out["cuda"][2][moment][pname], t)


# --------------------------------------------------------------------------
# the tuner and the analysis service on the card
# --------------------------------------------------------------------------
def _around(target, others, pos):
    return torch.cat([others[:pos], target, others[pos:]])


@pytest.mark.parametrize("n", [700, 1500, 16384])
def test_permute_reduce_rows_do_not_depend_on_b(cuda, n):
    """One permutation's S = 1 and S = 2 outputs are bitwise the same in
    tiles of B = 32, of the card solver's B and of 128/S: a launch's grid
    comes from the occupancy its shared memory allows, which S·B sets, so
    the tuner may change B only if the grid, and with it the grouping of
    the fp64 partials, does not move."""
    from repro_torch.tune import solve_tiles
    xc = random_distance_matrix(n + 11, n, device=cuda).condensed_form()
    ys = torch.randn((2, xc.numel()), generator=torch.Generator()
                     .manual_seed(n)).to(cuda)
    target = permutation_orders(n + 12, 1, n, cuda)
    solved = solve_tiles(n).batch_size
    for rows in (1, 2):
        sizes = sorted({32, solved, 128 // rows})
        grids = {_build.resident_grid("repro_permute_reduce_grid", n, rows,
                                      min(b, 128 // rows)) for b in sizes}
        outs = set()
        for b in sizes:
            others = permutation_orders(n + 13, b - 1, n, cuda)
            outs.add(_bits(permute_reduce(xc, ys[:rows],
                                          _around(target, others, 5))[:, 5]))
        assert len(outs) == 1, (rows, sizes, grids)
        assert len(grids) == 1, (rows, sizes, grids)


@pytest.mark.parametrize("method", ["mantel", "partial_mantel", "anosim",
                                    "permanova", "permdisp"])
def test_tile_statistics_do_not_depend_on_b(cuda, method):
    """A permutation's statistic is bitwise the same in a tile of 32, of
    the card solver's 64 and of 128 rows, for every test of the battery:
    what lets ``ExecConfig(auto=True)`` change B and keep the default
    session's bits."""
    from repro_torch.stats import engine
    n = 700
    d, y, z = (random_distance_matrix(s, n, dim=5, device=cuda).data
               for s in (31, 32, 33))
    ws = Workspace(d)
    kw = {"mantel": {"other": Workspace(y)},
          "partial_mantel": {"other": Workspace(y), "control": Workspace(z)},
          "permdisp": {"grouping": np.arange(n) % 4, "dimensions": 10}
          }.get(method, {"grouping": np.arange(n) % 4})
    stat, _ = ws.statistic(method, **kw)
    inv, _ = engine.hoist_and_observe(stat, cuda)
    target = permutation_orders(41, 1, n, cuda)
    got = set()
    for b in (32, 64, 128):
        others = permutation_orders(42 + b, b - 1, n, cuda)
        got.add(_bits(engine.tile_statistics(
            stat, inv, _around(target, others, 7))[7]))
    assert len(got) == 1, method


class _FailingPermuteReduce:
    """The bound library, except that ``permute_reduce``'s partials launch
    reports a CUDA error (``cudaErrorInvalidValue``) without launching."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def repro_permute_reduce_partials(self, *args):
        return 1


def test_a_failing_launch_fails_the_service_run(cuda, monkeypatch):
    """A kernel launch that reports a CUDA error leaves ``step()`` as a
    ``KernelError``: no retry, no breaker, no degraded answer."""
    from repro_torch.serve import AnalysisService, ServeConfig
    n = 300
    svc = AnalysisService(ServeConfig(timeout_s=None))
    svc.upload("x", random_distance_matrix(51, n, device=cuda).data)
    svc.upload("y", random_distance_matrix(52, n, device=cuda).data)
    h = svc.submit("x", "mantel", other="y", permutations=99, key=3)
    lib = _build.library()
    monkeypatch.setattr(_build, "library", lambda: _FailingPermuteReduce(lib))
    with pytest.raises(_build.KernelError, match="permute_reduce"):
        svc.run()
    assert h.status == "active" and not h.done
    m = svc.metrics
    assert (m.retries, m.breaker_trips, m.degraded, sum(
        m.tile_failures.values())) == (0, 0, 0, 0)


def test_service_is_bitwise_standalone_workspaces(cuda):
    """The service on the card (B = 32, auto-tuned sessions): a dozen
    mixed requests on square and feature studies, coalesced, each bitwise
    the same request run alone through a default ``Workspace`` with the
    same seed; each lane ran ceil(ΣK/B) tiles, each hoist was built once,
    and the ledgers charge ANOSIM's tiles to ``within_sums`` and the
    others to the row-stationary model."""
    from repro_torch.serve import AnalysisService, ServeConfig
    n = 700
    rng = np.random.default_rng(5)
    feats = [rng.random((n, 64)).astype(np.float32) for _ in range(2)]
    squares = [random_distance_matrix(s, n, dim=5, device=cuda).data
               for s in (61, 62, 63)]
    groups = np.arange(n) % 4
    svc = AnalysisService(ServeConfig())
    for i, sq in enumerate(squares):
        svc.upload(f"s{i}", sq)
    for i, f in enumerate(feats):
        svc.upload(f"f{i}", features=f)
    assert svc.pool.get("s0").tuned.budget.backend == "cuda"
    ks = iter((999, 17, 499, 249, 99, 49) * 2)
    plan = []
    for x, y, z in (("s0", "s1", "s2"), ("f0", "f1", "s2")):
        plan += [(x, "mantel", {"other": y}), (x, "mantel", {"other": y}),
                 (x, "anosim", {"grouping": groups}),
                 (x, "permanova", {"grouping": groups}),
                 (x, "permdisp", {"grouping": groups, "dimensions": 10}),
                 (x, "partial_mantel", {"other": y, "control": z})]
    _build.reset_launches()
    handles = [(x, m, kw, k, svc.submit(x, m, permutations=k, key=i, **kw))
               for i, ((x, m, kw), k) in enumerate(zip(plan, ks))]
    svc.run()
    launched = {k for k, v in _build.launches.items() if v}
    assert {"inverse_orders", "permute_reduce", "permute_reduce_finish",
            "within_sums", "within_sums_finish",
            "center_matvec", "center_pass1", "center_finish",
            "center_pass2"} <= launched
    lanes = {}
    for x, m, kw, k, h in handles:
        assert h.status == "done", h.payload()
        lanes[x, m] = lanes.get((x, m), 0) + k
    assert svc.scheduler.tiles_run == sum(-(-k // 32)
                                          for k in lanes.values())
    alone = {"s0": Workspace(squares[0]), "s1": Workspace(squares[1]),
             "s2": Workspace(squares[2]),
             "f0": Workspace.from_features(feats[0]),
             "f1": Workspace.from_features(feats[1])}
    for i, (x, m, kw, k, h) in enumerate(handles):
        args = {key: (alone[v] if key in ("other", "control") else v)
                for key, v in kw.items()}
        want = getattr(alone[x], m)(permutations=k, key=i, **args)
        assert (h.result.statistic, h.result.p_value) == \
            (want.statistic, want.p_value), (x, m, k)
        assert h.updates[-1].p_lo == h.updates[-1].p_hi == h.result.p_value
    for sid in ("s0", "f0"):
        ws = svc.pool.get(sid)
        assert all(v == 1 for v in ws.cache.misses.values()), sid
        models = {(e.op.endswith(":anosim"), e.params["model"])
                  for e in ws.obs.ledger.entries if e.op.startswith("perm:")}
        # ANOSIM's tiles charge its own kernel, every other lane's the
        # row-stationary permute_reduce
        assert models == {(True, "within_sums"), (False, "row_stationary")}


# --------------------------------------------------------------------------
# block and column-range modes (the distributed paths' kernels)
# --------------------------------------------------------------------------
def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary: the kernels take their scalar routes."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


# (r, c): square, a 2 x 2 split's block, ragged rows and columns, wide
BLOCKS = [(512, 512), (1000, 700), (1001, 333), (129, 4096), (700, 1000)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("r,c", BLOCKS)
def test_center_block_mode_matches_plain(cuda, r, c, aligned):
    d = _matrix(max(r, c), r + c, cuda)[:r, :c].contiguous()
    d = d if aligned else _misaligned(d)
    gen = torch.Generator().manual_seed(r * c)
    row_means = torch.randn(r, generator=gen).to(cuda)
    col_means = torch.randn(c, generator=gen).to(cuda)
    gm = torch.randn(1, generator=gen).to(cuda)
    np.testing.assert_allclose(center_pass1(d).cpu().numpy(),
                               center_pass1_ref(d).cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    got = center_pass2(d, row_means, gm, col_means)
    want = center_pass2_ref(d, row_means, gm, col_means)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    assert torch.equal(got, center_pass2(d, row_means, gm, col_means))


@pytest.mark.parametrize("n", [1000, 1001])
def test_center_square_call_is_the_block_call(cuda, n):
    """The square call is the block call with r = c = n and the row means
    as the column means: the same bits."""
    d = _matrix(n, n + 5, cuda)
    row_sums = center_pass1(d)
    row_means, gm = center_finish(row_sums)
    assert torch.equal(center_pass2(d, row_means, gm),
                       center_pass2(d, row_means, gm, row_means.clone()))
    assert torch.equal(center_distance_matrix_op(d),
                       center_pass2(d, row_means, gm))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("r,c,k", [(512, 512, 20), (1000, 700, 20),
                                   (1001, 333, 45), (129, 4096, 7),
                                   (700, 1000, 128), (8192, 8192, 20),
                                   (8192, 8192, 128), (8320, 4096, 20),
                                   (129, 40, 7)])
def test_center_matvec_block_mode_matches_plain(cuda, r, c, k, aligned):
    """Each strip swept by a cluster of ``sweep_split`` blocks: 2 at a 2 x 2
    mesh's (8192, 8192) block and at 65 strips, 8 at (512, 512), 2 where
    two stages are all there is (129, 40)."""
    d = _matrix(max(r, c), r + c + 1, cuda)[:r, :c].contiguous()
    d = d if aligned else _misaligned(d)
    gen = torch.Generator().manual_seed(r + c + k)
    x = torch.randn((c, k), generator=gen).to(cuda)
    row_means = torch.randn(r, generator=gen).to(cuda)
    colsum = torch.randn(k, generator=gen).to(cuda)
    corr = torch.randn(k, generator=gen).to(cuda)
    got = center_matvec(d, x, row_means, colsum, corr)
    want = center_matvec_block_ref(d, x, row_means, colsum, corr)
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * max(scale, 1.0))
    assert torch.equal(got, center_matvec(d, x, row_means, colsum, corr))
    _build.reset_launches()
    product = block_product_op(d, x)
    assert _build.launches["center_matvec"] == 1
    want = center_matvec_block_ref(d, x, *(torch.zeros_like(v) for v in
                                           (row_means, colsum, corr)))
    scale = want.abs().max().item()
    np.testing.assert_allclose(product.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * max(scale, 1.0))


@pytest.mark.parametrize("k", [20, 128])
def test_center_matvec_main_path_square_is_one_block_a_strip(cuda, k):
    """The main path's square call at n = 16384 fills the card with its
    128 strips, so it takes no cluster (one block a strip), and matches
    its plain version."""
    n = 16384
    assert sweep_split(n, n, k) == 1
    d, x, row_means, gm = _center_matvec_operands(n, k, cuda)
    got = center_matvec_op(d, x, row_means, gm)
    want = center_matvec_ref(d, x, row_means, gm)
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * max(scale, 1.0))
    assert torch.equal(got, center_matvec_op(d, x, row_means, gm))


@pytest.mark.parametrize("k", [7, 20, 45, 128])
def test_center_matvec_clusters_run_in_one_wave(cuda, k):
    """The card holds at once as many clusters of each size as
    ``sweep_split`` counts on (``RESIDENT_CLUSTERS``), so a launch's
    clusters run in one wave."""
    for s in SWEEP_SPLITS:
        assert resident_clusters(k, s) >= RESIDENT_CLUSTERS[s], (k, s)


@pytest.mark.parametrize("n,c0,c", [(1000, 0, 1000), (1000, 500, 500),
                                    (1000, 3, 700), (1001, 0, 1001),
                                    (1001, 4, 500), (1024, 256, 256),
                                    (1024, 1020, 4)])
def test_mantel_corr_column_range_matches_plain(cuda, n, c0, c):
    """Columns [c0, c0 + c) of ŷ against the plain version: aligned
    (vector path) and unaligned c0 or ragged n and c (scalar path)."""
    x = _matrix(n, n + 7, cuda)
    gen = torch.Generator().manual_seed(n + c0)
    yhat = torch.randn((n, c), generator=gen).to(cuda)
    orders = permutation_orders(n + c, 27, n, cuda)
    got = mantel_corr(x, yhat, orders, c0)
    want = mantel_corr_plain(x, yhat, orders, c0)
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * max(scale, 1.0))
    assert torch.equal(got, mantel_corr(x, yhat, orders, c0))
    np.testing.assert_allclose(got.cpu().numpy(), mantel_corr_rows(
        x.cpu(), yhat.cpu(), orders.cpu(), c0).numpy(), rtol=1e-5,
        atol=1e-5 * max(scale, 1.0))


def test_mantel_corr_square_is_the_whole_column_range(cuda):
    n = 1000
    x = _matrix(n, 11, cuda)
    yhat = torch.randn((n, n), generator=torch.Generator().manual_seed(11)
                       ).to(cuda)
    orders = permutation_orders(12, 27, n, cuda)
    assert torch.equal(mantel_corr(x, yhat, orders),
                       mantel_corr(x, yhat, orders, 0))


def test_one_rank_nccl_mesh_centers_bitwise_like_the_square(cuda):
    """A 1 x 1 NCCL mesh: the distributed centering's block is
    ``center_distance_matrix``'s F, bit for bit; the matvec and the
    distributed Mantel agree with the single-device routes."""
    mesh = make_host_mesh((1, 1), device_type="cuda")
    dm = random_distance_matrix(21, 1000, device=cuda)
    _build.reset_launches()
    f = center_distance_matrix_distributed(dm.data, mesh)
    assert (_build.launches["center_pass1"], _build.launches["center_finish"],
            _build.launches["center_pass2"]) == (1, 1, 1)
    assert torch.equal(full_tensor(f), center_distance_matrix(dm.data))
    x = torch.randn((1000, 20), generator=torch.Generator().manual_seed(3)
                    ).to(cuda)
    op = CenteredGramOperator.from_distance(dm.data)
    want = op.matvec(x)
    got = full_tensor(centered_gram_matvec_distributed(dm.data, x, mesh))
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * max(scale, 1.0))
    y = random_distance_matrix(22, 1000, device=cuda)
    orders = permutation_orders(23, 64, 1000, cuda)
    _build.reset_launches()
    observed, null = mantel_null_distributed(dm, y, mesh, 64, orders=orders)
    assert _build.launches["mantel_corr"] == 1
    stat = MantelStatistic(dm.data, y.data, 1000)
    inv, want_observed = hoist_and_observe(stat, cuda)
    want = null_distribution(stat, inv, orders, 32)
    np.testing.assert_allclose(null.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(observed, want_observed)
    assert torch.equal(
        null_distribution_distributed(stat, inv, mesh, 64, orders=orders,
                                      batch_size=32), want)


def test_a_cuda_tensor_on_a_cpu_mesh_is_refused(cuda):
    """The distributed paths refuse a tensor off the mesh's device type
    before any collective (``launch.mesh.check_device``)."""
    from types import SimpleNamespace

    with pytest.raises(ValueError, match="cuda tensor on a cpu mesh"):
        check_device(SimpleNamespace(device_type="cpu"),
                     torch.zeros(2, device=cuda))


@pytest.mark.parametrize("name,s,changes", [
    ("granite-moe-1b-a400m", 48, {}),
    ("granite-moe-1b-a400m", 16, {"capacity_factor": 0.5}),
    ("grok-1-314b", 20, {})])
def test_moe_card_matches_cpu(cuda, name, s, changes):
    """The MoE FFN at the smoke widths in fp32: the card routes every pair
    as the CPU does (a flip is reported as one), then y and aux agree."""
    cfg = dataclasses.replace(get_arch(name, smoke=True), **changes)
    cpu = moe_mod.MoE(cfg, "cpu")
    cpu.reset_parameters(torch.Generator().manual_seed(1))
    card = moe_mod.MoE(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((2, s, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    chunk = cfg.moe_chunk if s % cfg.moe_chunk == 0 else s
    for i in range(0, s, chunk):
        got = moe_mod.route(card, x[:, i:i + chunk].to(cuda), cfg)
        want = moe_mod.route(cpu, x[:, i:i + chunk], cfg)
        for j, what in ((1, "expert"), (3, "slot"), (4, "keep")):
            flips = int((got[j].cpu() != want[j]).sum())
            assert flips == 0, f"chunk {i // chunk}: {flips} {what} flips"
    with torch.no_grad():
        y, aux = moe_mod.moe_ffn(card, x.to(cuda), cfg)
        want_y, want_aux = moe_mod.moe_ffn(cpu, x, cfg)
    torch.testing.assert_close(y.cpu(), want_y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-5)


def test_int8_ring_cache_card_matches_cpu(cuda):
    """A ring of 4 slots holding int8 K/V: a prefill of 10 positions and 6
    decode steps through one attention layer, card against CPU."""
    cfg = dataclasses.replace(get_arch("qwen3-8b", smoke=True),
                              kv_quant=True)
    window = 4
    cpu = attn_mod.Attention(cfg, "cpu")
    cpu.reset_parameters(torch.Generator().manual_seed(3))
    card = attn_mod.Attention(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(4))
    pos = torch.arange(10, dtype=torch.int32).expand(2, 10)
    caches, outs = {}, {}
    with torch.no_grad():
        for dev, p in ((torch.device("cpu"), cpu), (cuda, card)):
            xd = x.to(dev)
            _, (k, v) = attn_mod.attn_forward(p, xd[:, :10], pos.to(dev),
                                              cfg, window=window)
            cache = attn_mod.fill_cache_from_prefill(
                attn_mod.init_attn_cache(cfg, 2, 16, window=window,
                                         device=dev), k, v, window=window)
            steps = []
            for t in range(10, 16):
                out, cache = attn_mod.attn_decode(p, xd[:, t:t + 1], cache, t,
                                                  cfg, window=window)
                steps.append(out.cpu())
            caches[dev.type], outs[dev.type] = cache, torch.cat(steps, dim=1)
    got, want = caches[cuda.type], caches["cpu"]
    assert torch.equal(got.pos.cpu(), want.pos)
    assert sorted(want.pos.tolist()) == [12, 13, 14, 15]
    for key in ("k", "v"):
        diff = (getattr(got, key).cpu().int() - getattr(want, key).int())
        assert int(diff.abs().max()) <= 1, key
        torch.testing.assert_close(getattr(got, f"{key}_scale").cpu(),
                                   getattr(want, f"{key}_scale"), rtol=1e-6,
                                   atol=1e-12)
    torch.testing.assert_close(outs[cuda.type], outs["cpu"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m",
                                  "phi-3-vision-4.2b", "mamba2-1.3b",
                                  "recurrentgemma-9b"])
def test_new_arch_decode_step_launches_rmsnorm_exactly(cuda, name):
    """One smoke decode step on the card: two norms a layer (the block
    norms; an SSD layer's block norm and gated norm) and the final norm,
    each one ``rmsnorm`` launch (no qk-norm in any)."""
    cfg = get_arch(name, smoke=True)
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(5),
                        cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 9), device=cuda)
    extra = (torch.randn((2, cfg.n_patches, cfg.frontend_dim), device=cuda)
             if cfg.frontend == "vision" else None)
    _, cache = prefill(model, tokens[:, :8], cfg, extra, max_len=32)
    _build.reset_launches()
    hidden, cache = decode_step(model, tokens[:, 8:], cache, cfg)
    torch.cuda.synchronize()
    assert _build.launches["rmsnorm"] == 2 * cfg.n_layers + 1
    assert bool(torch.isfinite(hidden).all())


def test_fp32_products_are_ieee_on_the_card(cuda):
    """``repro_torch`` keeps TF32 off: an fp32 ``mm`` and ``bmm`` on the
    card (the MoE's expert products at granite-moe's widths) agree with
    fp64 to fp32's rounding, where TF32 would miss by ~1e-3."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    a = torch.randn((8, 2048, 1024), generator=gen, device=cuda)
    b = torch.randn((8, 1024, 512), generator=gen, device=cuda)
    for got, want in ((torch.bmm(a, b), torch.bmm(a.double(), b.double())),
                      (a[0] @ b[0], a[0].double() @ b[0].double())):
        err = float((got.double() - want).abs().max() / want.abs().max())
        assert err < 1e-5, err


def test_moe_token_alone_matches_its_chunk_at_full_width(cuda):
    """granite-moe's MoE layer at full width in fp32, dropless: a token run
    alone (decode) and within a chunk of 528 (prefill) choose the same
    experts and give the same output to fp32's rounding."""
    cfg = get_arch("granite-moe-1b-a400m")
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32",
                              capacity_factor=float(cfg.n_experts))
    p = moe_mod.MoE(cfg, cuda)
    p.reset_parameters(torch.Generator(device=cuda).manual_seed(7))
    x = torch.randn((4, 528, cfg.d_model),
                    generator=torch.Generator(device=cuda).manual_seed(8),
                    device=cuda)
    with torch.no_grad():
        ids_all = moe_mod.route(p, x, cfg)[1][:, -1]
        ids_one = moe_mod.route(p, x[:, -1:], cfg)[1][:, 0]
        assert torch.equal(ids_all.sort(-1).values, ids_one.sort(-1).values)
        y_all = moe_mod.moe_ffn(p, x, cfg)[0][:, -1]
        y_one = moe_mod.moe_ffn(p, x[:, -1:], cfg)[0][:, 0]
    scale = float(y_all.abs().max())
    err = float((y_all - y_one).abs().max())
    assert err <= 1e-5 * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("name", ["mamba2-1.3b", "recurrentgemma-9b",
                                  "seamless-m4t-medium"])
def test_recurrent_and_encdec_smokes_card_match_cpu(cuda, name):
    """The smoke served in fp32 on the card and on the CPU from the same
    weights (norm weights and biases drawn non-zero): a prefill of 20
    tokens (recurrentgemma's ring of 16 overflows; seamless on 5 frames)
    and 6 decode steps; the logits, and the last cache's recurrent states
    or cross K/V, agree."""
    cfg = get_arch(name, smoke=True)
    cpu = models.init_model(cfg, torch.Generator().manual_seed(8), "cpu")
    with torch.no_grad():
        for pname, p in cpu.named_parameters():
            if p.ndim == 1 and not pname.endswith(("lambda", "dt_bias",
                                                   "a_log")):
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator(
                    ).manual_seed(len(pname))))
    card = models.build_model(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab, (2, 26),
                           generator=torch.Generator().manual_seed(9))
    extra = ({"frames": torch.randn((2, 5, cfg.frontend_dim),
                                    generator=torch.Generator().manual_seed(
                                        10))} if cfg.is_encdec else {})
    out, caches = {}, {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        prefill = build_prefill_fn(cfg, max_len=28, device=dev)
        decode = build_decode_fn(cfg, device=dev)
        _build.reset_launches()
        logits, cache = prefill(model, {"tokens": tokens[:, :20],
                                        **{k: v.to(dev)
                                           for k, v in extra.items()}})
        steps = [logits]
        for t in range(20, 26):
            logits, cache = decode(model, tokens[:, t:t + 1], cache)
            steps.append(logits)
        norms = 0 if cfg.norm == "layernorm" else 2 * cfg.n_layers + 1
        assert _build.launches["rmsnorm"] == (0 if dev == "cpu"
                                              else 7 * norms), dev
        out[dev], caches[dev] = torch.cat(steps, dim=1).cpu(), cache

    def close(got, want):
        scale = float(want.abs().max())
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                   atol=1e-5 * max(scale, 1.0))
    close(out["cuda"], out["cpu"])
    if cfg.is_encdec:
        for c_card, c_cpu in zip(caches["cuda"].dec, caches["cpu"].dec):
            close(c_card.cross_k, c_cpu.cross_k)
            close(c_card.cross_v, c_cpu.cross_v)
    else:
        for c_card, c_cpu in zip(caches["cuda"].blocks,
                                 caches["cpu"].blocks):
            if hasattr(c_cpu, "h"):
                close(c_card.h, c_cpu.h)
                close(c_card.conv, c_cpu.conv)


def test_ssd_decay_gradient_is_finite_on_the_card(cuda):
    """mamba2's smoke SSD at chunk 256, one chunk of standard-normal input,
    where the reference's form overflows: the card's output is the CPU's,
    and every gradient is finite on the card."""
    cfg = dataclasses.replace(get_arch("mamba2-1.3b", smoke=True),
                              ssm_chunk=256)
    cpu = ssd_mod.SSD(cfg, "cpu")
    cpu.reset_parameters(torch.Generator().manual_seed(11))
    card = ssd_mod.SSD(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((1, 256, cfg.d_model),
                    generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        want, _ = ssd_mod.ssd_forward(cpu, x, cfg)
    xc = x.to(cuda).requires_grad_(True)
    got, _ = ssd_mod.ssd_forward(card, xc, cfg)
    scale = float(want.abs().max())
    torch.testing.assert_close(got.detach().cpu(), want, rtol=1e-5,
                               atol=1e-5 * max(scale, 1.0))
    got.sum().backward()
    assert bool(torch.isfinite(xc.grad).all())
    for pname, p in card.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), \
            pname


@pytest.mark.parametrize("name", ["qwen3-8b", "granite-moe-1b-a400m"])
def test_one_rank_nccl_mesh_trains_and_serves_bitwise(cuda, name):
    """The sharded train, prefill and decode steps on a 1 x 1 NCCL mesh
    issue no collective and are the single-process steps, bit for bit,
    with the same ``rmsnorm`` launches."""
    from repro_torch.configs import get_arch
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.serve import (build_decode_fn, build_prefill_fn,
                                           make_decode_step,
                                           make_prefill_step)
    from repro_torch.runtime.train import (build_train_step_fn,
                                           init_train_state, make_train_step)
    from repro_torch.sharding import make_rules

    cfg = dataclasses.replace(get_arch(name, smoke=True), microbatches=2)
    mesh = make_host_mesh((1, 1), device_type="cuda")
    rules = make_rules(mesh)
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=10)
    gen = torch.Generator().manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab, (4, 16), generator=gen)
             for k in ("tokens", "targets")}
    runs = {}
    for kind in ("single", "mesh"):
        model, state = init_train_state(5, cfg, device=cuda)
        step = (build_train_step_fn(cfg, opt) if kind == "single" else
                make_train_step(cfg, opt, mesh, rules, model, state))
        _build.reset_launches()
        losses = [float(step(model, state, batch)[2]["loss"])
                  for _ in range(2)]
        launches = dict(_build.launches)
        prompt = {"tokens": batch["tokens"]}
        prefill, decode = ((build_prefill_fn(cfg, 20), build_decode_fn(cfg))
                           if kind == "single" else
                           (make_prefill_step(cfg, mesh, rules, model,
                                              prompt, 20),
                            make_decode_step(cfg, mesh, rules, model, None)))
        logits, cache = prefill(model, prompt)
        out = [full_tensor(logits)]
        for _ in range(3):
            logits, cache = decode(model, out[-1][:, -1].argmax(
                -1, keepdim=True), cache)
            out.append(full_tensor(logits))
        runs[kind] = (losses, launches, {n: full_tensor(p) for n, p in
                                         model.named_parameters()}, out)
    assert runs["single"][0] == runs["mesh"][0]
    assert runs["single"][1] == runs["mesh"][1]
    for n, p in runs["single"][2].items():
        assert torch.equal(p, runs["mesh"][2][n]), n
    for a, b in zip(runs["single"][3], runs["mesh"][3]):
        assert torch.equal(a, b)


def test_probe_permute_reduce_on_the_card_is_within_its_bands(cuda):
    """One (32, 4096) tile probed on the card: the row-stationary launches
    declared their loads and stores, the record's bytes and its peak from
    the caching allocator lie within the ``"cuda"`` bands, the peak is at
    least the arguments, and the launch counts are as they were."""
    from repro_torch.obs.drift import DriftSentinel
    from repro_torch.obs.probe import clear_probe_cache, probe_permute_reduce

    clear_probe_cache()
    before = dict(_build.launches)
    rec = probe_permute_reduce(4096, batch=32)
    assert _build.launches == before
    assert rec.backend == "cuda"
    assert set(rec.launches) == {"inverse_orders", "permute_reduce",
                                 "permute_reduce_finish"}
    assert all(v["count"] == 1 for v in rec.launches.values())
    assert rec.peak_bytes >= rec.argument_bytes
    verdicts = DriftSentinel(backend="cuda").check_permute_reduce(rec)
    for v in verdicts:
        assert v.within, v


def test_sparse_route_session_reports_drift_ok_on_the_card(cuda):
    """A feature session on a count table below ``SPARSE_SHARE``: its
    production takes the sparse route, and after its pcoa the probed
    report measures one panel of that route on the card (the sparse
    kernel, declared), every verdict within its band; the report's tiles
    name the route and the condensed product's strips."""
    from repro_torch.obs import ObsConfig
    from repro_torch.obs.probe import clear_probe_cache

    rng = np.random.default_rng(33)
    x = ((rng.random((1000, 3000)) < 0.02)
         * rng.integers(1, 40, (1000, 3000))).astype(np.float32)
    clear_probe_cache()
    ws = Workspace.from_features(x, config=ExecConfig(
        obs=ObsConfig(enabled=True)))
    ws.pcoa(dimensions=3)
    rep = ws.report()
    tiles = rep.meta["tiles"]
    assert tiles["production_route"]["route"] == "sparse"
    assert tiles["condensed_matvec_strip_rows"] == STRIP_ROWS
    panel = rep.measured["dist.panel_stats"]
    assert panel["params"]["route"] == "sparse"
    assert panel["params"]["nnz"] == int((x != 0).sum())
    assert set(panel["launches"]) == {"pairwise_sparse_panel"}
    assert {r["backend"] for r in rep.measured.values()} == {"cuda"}
    assert rep.drift["backend"] == "cuda" and rep.drift_ok, rep.drift


def test_probed_report_leaves_launch_counts_as_found(cuda):
    """A probed ``report()`` of a card session launches the probes'
    kernels but leaves ``_build.launches`` and the cache counters as it
    found them; every ``measured`` record ran on the card."""
    from repro_torch.obs import ObsConfig

    d = random_distance_matrix(3, 512, device=cuda)
    ws = Workspace(d, config=ExecConfig(obs=ObsConfig(enabled=True)))
    ws.pcoa(dimensions=3)
    ws.mantel(ws, permutations=31)
    launches = dict(_build.launches)
    cache = (dict(ws.cache.hits), dict(ws.cache.misses))
    rep = ws.report()
    assert _build.launches == launches
    assert (dict(ws.cache.hits), dict(ws.cache.misses)) == cache
    assert {r["backend"] for r in rep.measured.values()} == {"cuda"}
    assert rep.drift["backend"] == "cuda" and rep.drift_ok, rep.drift
