"""Port parity: the pairwise-panel kernel's plain versions.

The same numpy tables go through the reference's Pallas kernel
(``pairwise_panel_pallas``, in interpret mode on the CPU) and its naive
oracle ``pairwise_ref``, and through the port's wrapper on a CPU tensor
(the plain chunked panel) and its oracle. Tolerance rtol 1e-5 / atol 1e-6,
the reference's own (``tests/test_dist.py::test_pairwise_kernel_matches_ref``):
the features are summed in chunks, in another order.

The sparse-support route (``pairwise_sparse_panel_ref``, the plain version
of ``csrc/pairwise_sparse.cu``) is held the same way on numpy tables at
0.5%, 1.3% and 5% nonzero: signed and non-negative values, an all-zero
row, an all-zero pair (0/0 → 0) and a ragged d, at the same tolerance (it
sums over one row's nonzeros, in another order again).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.dist import get_metric as jax_get_metric
from repro.kernels.pairwise_ops import pairwise_panel_pallas
from repro.kernels.pairwise_ref import pairwise_ref as jax_pairwise_ref
from repro_torch.dist import METRICS, get_metric
from repro_torch.kernels.pairwise import (SPARSE_SHARED_BYTES, sparse_rows,
                                          sparse_shared_bytes)
from repro_torch.kernels.pairwise_ops import (SparseBrayCurtis,
                                              pairwise_panel_op,
                                              row_nonzeros, row_support)
from repro_torch.kernels.pairwise_ref import pairwise_ref

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _table(seed, n, d):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(size=(n, d)))
    x[rng.random(size=x.shape) < 0.2] = 0.0
    return x.astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("metric", sorted(METRICS))
@pytest.mark.parametrize("n,d,block,fb", [(30, 11, 8, 4), (17, 7, 16, 16),
                                          (32, 12, 8, 5)])
def test_plain_panel_matches_pallas_kernel(metric, n, d, block, fb):
    x = _table(3, n, d)
    want = pairwise_panel_pallas(jnp.asarray(x[:10]), jnp.asarray(x),
                                 metric=jax_get_metric(metric),
                                 block_n=block, feature_block=fb)
    got = pairwise_panel_op(torch.from_numpy(x[:10]), torch.from_numpy(x),
                            metric)
    _close(got, want)
    _close(got, jax_pairwise_ref(jnp.asarray(x[:10]), jnp.asarray(x),
                                 metric))


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_oracle_matches_reference_oracle(metric):
    x = _table(4, 19, 13)
    y = _table(5, 11, 13)
    _close(pairwise_ref(torch.from_numpy(x), torch.from_numpy(y), metric),
           jax_pairwise_ref(jnp.asarray(x), jnp.asarray(y), metric))


def test_panel_edges():
    """A panel of no rows, and a table of no features (every distance 0)."""
    x = torch.from_numpy(_table(6, 9, 4))
    assert pairwise_panel_op(x[:0], x).shape == (0, 9)
    empty = torch.zeros((5, 0))
    for metric in sorted(METRICS):
        assert torch.equal(pairwise_panel_op(empty[:2], empty, metric),
                           torch.zeros(2, 5))


def test_kinds_agree_with_the_kernel_enum():
    """``Metric.kind`` selects the kernel's template: the two numberings
    must be the same."""
    text = (CSRC / "pairwise.cu").read_text()
    enum = dict(re.findall(r"k(\w+) = (\d)", text.split("enum Kind {")[1]
                           .split("};")[0]))
    names = {"Euclidean": "euclidean", "Cityblock": "cityblock",
             "Canberra": "canberra", "BrayCurtis": "braycurtis",
             "Jaccard": "jaccard"}
    assert {names[k]: int(v) for k, v in enum.items()} == \
        {name: m.kind for name, m in METRICS.items()}


def test_wrapper_checks_operands():
    x = torch.from_numpy(_table(7, 6, 3))
    with pytest.raises(ValueError, match="tables"):
        pairwise_panel_op(x[:2, :2], x)
    with pytest.raises(TypeError, match="float32"):
        pairwise_panel_op(x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        pairwise_panel_op(x[:, ::2].T.contiguous().T, x[:, :2])
    with pytest.raises(ValueError, match="unknown metric"):
        pairwise_panel_op(x, x, "chebyshev")
    assert get_metric("braycurtis").kind == 3


def _sparse_table(seed, n, d, share, signed):
    """An (n, d) table with about ``share`` of its entries nonzero, row 0
    all zeros and rows 2 and 5 an all-zero pair."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    if not signed:
        x = np.abs(x)
    x[rng.random(size=x.shape) >= share] = 0.0
    x[[0, 2, 5]] = 0.0
    x[1, rng.integers(0, d, size=3)] = 1.5    # row 1 is never empty
    return x.astype(np.float32)


def _support(x):
    counts = row_nonzeros(x)
    return row_support(x, counts, int(counts.max()))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("share,d", [(0.005, 1531), (0.013, 777),
                                     (0.05, 301)])
@pytest.mark.parametrize("row0,bm", [(0, 10), (17, 23)])
def test_sparse_plain_panel_matches_pallas_kernel(share, d, signed, row0,
                                                  bm):
    x = _sparse_table(8, 40, d, share, signed)
    xt = torch.from_numpy(x)
    got = pairwise_panel_op(xt[row0:row0 + bm], xt,
                            SparseBrayCurtis(_support(xt)))
    want = pairwise_panel_pallas(jnp.asarray(x[row0:row0 + bm]),
                                 jnp.asarray(x),
                                 metric=jax_get_metric("braycurtis"),
                                 block_n=16, feature_block=128)
    _close(got, want)
    _close(got, jax_pairwise_ref(jnp.asarray(x[row0:row0 + bm]),
                                 jnp.asarray(x), "braycurtis"))
    rows = torch.arange(bm)
    assert bool((got[rows, row0 + rows] == 0).all())      # the diagonal
    if row0 == 0:
        assert float(got[2, 5]) == 0.0 and float(got[5, 2]) == 0.0
        assert float(got[0, 1]) == 1.0                 # a zero row, 1 away


def test_row_support_is_the_tables_nonzeros():
    x = torch.from_numpy(_sparse_table(9, 30, 211, 0.05, True))
    sup = _support(x)
    counts = (x != 0).sum(dim=1)
    assert (sup.n, sup.d, sup.nnz) == (30, 211, int(counts.sum()))
    assert sup.max_row == int(counts.max())
    assert torch.equal(row_nonzeros(x), counts)
    assert sup.offsets.dtype == sup.indices.dtype == torch.int32
    assert torch.equal(sup.offsets[1:].long(), torch.cumsum(counts, 0))
    dense = torch.zeros_like(x)
    owner = torch.repeat_interleave(torch.arange(30), counts)
    dense[owner, sup.indices.long()] = sup.values
    assert torch.equal(dense, x)
    for r in range(30):                   # features ascending within a row
        idx = sup.indices[sup.offsets[r]:sup.offsets[r + 1]]
        assert bool((idx[1:] > idx[:-1]).all())


def test_sparse_rows_fit_the_kernels_shared_memory():
    """At the HMP V3-V5 table's width a block holds 4 rows of up to ~2200
    nonzeros, 2 of ~8800, 1 of ~35000, and none past that."""
    d = 45383
    assert sparse_rows(d, 754) == 4
    assert sparse_rows(d, 8000) == 2
    assert sparse_rows(d, 20000) == 1
    assert sparse_rows(d, 40000) == 0
    assert sparse_rows(10, 1) == 4
    assert sparse_rows(200_000, 1) == 0          # the slot table alone
    for max_row in (1, 754, 2203, 2204, 8000, 35000):
        rows = sparse_rows(d, max_row)
        if rows:
            assert sparse_shared_bytes(d, rows, max_row) \
                <= SPARSE_SHARED_BYTES
        if rows < 4:
            assert sparse_shared_bytes(d, 2 * rows or 1, max_row) \
                > SPARSE_SHARED_BYTES


def test_sparse_panel_checks_its_operands():
    """The sparse panel's rows must be a view of rows of the table its
    support was made from."""
    x = torch.from_numpy(_sparse_table(10, 12, 50, 0.1, False))
    metric = SparseBrayCurtis(_support(x))
    assert metric.name == "braycurtis"
    with pytest.raises(ValueError, match="view of rows of x"):
        pairwise_panel_op(x[3:7].clone(), x, metric)
    with pytest.raises(ValueError, match="view of rows of x"):
        pairwise_panel_op(x.view(-1)[5:205].view(4, 50), x, metric)
    with pytest.raises(ValueError, match="support of 12 rows"):
        y = x[:, :40].contiguous()
        pairwise_panel_op(y[:4], y, metric)
    assert pairwise_panel_op(x[3:3], x, metric).shape == (0, 12)
    got = pairwise_panel_op(x[3:7], x, metric)
    assert torch.equal(got[:, 3:7].diagonal(), torch.zeros(4))
