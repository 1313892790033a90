"""Launches of the pairwise-panel CUDA kernels.

``pairwise_panel`` (``csrc/pairwise.cu``) replaces the Pallas kernel
``repro/kernels/pairwise.py::pairwise_panel``. A block owns a 64 × 64 tile
of the (bm, n) panel and loops over the features itself, 32 at a time,
staging both operands' tiles in shared memory; each thread keeps a 4 × 4
patch of the metric's accumulators in registers and writes each finished
distance once. Ragged bm, n and d are masked in the kernel, so nothing is
padded.

``pairwise_sparse_panel`` (``csrc/pairwise_sparse.cu``) replaces no Pallas
kernel: it is the Bray–Curtis panel of a table that is mostly zeros,
summed over each table row's nonzeros, read from the table's compressed
copy (``pairwise_ops.RowSupport``). A block holds R rows of the panel in
shared memory, a 16-bit slot a feature and R values a slot, and streams
the copy's rows past them; :func:`sparse_rows` picks R, the most whose
nonzeros fit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: output rows and columns one block owns (``kTile`` of ``csrc/pairwise.cu``)
TILE = 64
#: floating-point operations a (row, column, feature) term, by metric kind
#: (Euclidean, cityblock, Canberra, Bray–Curtis, Jaccard), as ``Metric::add``
#: of ``csrc/pairwise.cu`` spells them; abs, compares and selects not counted
TERM_OPERATIONS = (3, 2, 4, 4, 2)
#: fp32 instructions a term of the Euclidean and Bray–Curtis kernels, by
#: kind (an FMA is one instruction and two operations): what bounds a
#: panel at the card's instruction rate
TERM_INSTRUCTIONS = {0: 2, 3: 4}


def pairwise_cost(bm: int, n: int, d: int, kind: int) -> tuple[float, float]:
    """(bytes, operations) of one ``pairwise_panel`` launch: the block of
    each (64-row, 64-column) tile reads its xi rows and its x rows over all
    d features, so xi is read ceil(n / 64) times and x ceil(bm / 64) times
    (ragged rows masked, never loaded); each distance is stored once."""
    loads = 4.0 * d * (-(-n // TILE) * bm + -(-bm // TILE) * n)
    return loads + 4.0 * bm * n, float(TERM_OPERATIONS[kind]) * bm * n * d


#: shared memory a block of the sparse kernel may use: the H100's opt-in
#: limit (227 KB) less room for the kernel's static arrays
SPARSE_SHARED_BYTES = 232448 - 1024
#: panel rows a block of the sparse kernel may hold, the most first (the
#: kernel's instantiations)
SPARSE_ROWS = (4, 2, 1)
#: slots the sparse kernel numbers (16-bit), the zero slot included
SPARSE_SLOTS = 1 << 16
#: fp32 operations a (held row, nonzero) term of the sparse kernel: two
#: differences and three accumulates (``add_nonzero``)
SPARSE_TERM_OPERATIONS = 5


def sparse_slots(rows: int, max_row: int) -> int:
    """Slots a block holding ``rows`` panel rows needs at most: one for
    each nonzero of its rows, and the zero slot."""
    return rows * max_row + 1


def sparse_shared_bytes(d: int, rows: int, max_row: int) -> int:
    """Dynamic shared memory of a sparse block: the slot table (2 bytes a
    feature, padded to 16) and ``rows`` floats a slot."""
    return -(-2 * d // 16) * 16 + 4 * rows * sparse_slots(rows, max_row)


def sparse_rows(d: int, max_row: int) -> int:
    """R, the panel rows a block of the sparse kernel holds for a table of
    ``d`` features whose fullest row has ``max_row`` nonzeros: the most of
    ``SPARSE_ROWS`` whose slots fit, or 0 when even one row's do not."""
    for rows in SPARSE_ROWS:
        if (sparse_slots(rows, max_row) <= SPARSE_SLOTS
                and sparse_shared_bytes(d, rows, max_row)
                <= SPARSE_SHARED_BYTES):
            return rows
    return 0


def sparse_cost(bm: int, n: int, nnz: int, rows: int
                ) -> tuple[float, float]:
    """(bytes, operations) of one ``pairwise_sparse_panel`` launch: each
    group of ``rows`` panel rows streams every nonzero of the table (index
    and value, 8 bytes) and two row offsets a table row; each distance is
    stored once. The held rows' own reads (under 1% at R = 4) are left
    out."""
    groups = -(-bm // rows)
    loads = groups * (8.0 * nnz + 8.0 * n)
    return (loads + 4.0 * bm * n,
            float(SPARSE_TERM_OPERATIONS) * groups * rows * nnz)


def pairwise_panel(xi: torch.Tensor, x: torch.Tensor, kind: int
                   ) -> torch.Tensor:
    """(bm, n) distances between the rows of ``xi`` (bm, d) and ``x``
    (n, d) on the card, for the metric whose ``kind`` is given.

    Both fp32, contiguous, on one CUDA device. Returns without
    synchronising.
    """
    bm, d = xi.shape
    n = x.shape[0]
    out = torch.empty((bm, n), dtype=torch.float32, device=x.device)
    if bm == 0 or n == 0:
        return out
    err = _build.library().repro_pairwise_panel(
        xi.data_ptr(), x.data_ptr(), out.data_ptr(), bm, n, d, kind,
        _build.stream_handle(x.device))
    _build.launches["pairwise_panel"] += 1
    if _build.recorder is not None:
        _build.recorder("pairwise_panel", *pairwise_cost(bm, n, d, kind))
    _build.check(err, "pairwise_panel")
    return out


def pairwise_sparse_panel(support, row0: int, bm: int) -> torch.Tensor:
    """(bm, n) Bray–Curtis distances between the rows [row0, row0 + bm) of
    the table whose compressed copy is ``support`` (``RowSupport``, on one
    CUDA device) and all n of its rows, 0 on the diagonal. Returns without
    synchronising."""
    n = support.n
    out = torch.empty((bm, n), dtype=torch.float32,
                      device=support.values.device)
    if bm == 0 or n == 0:
        return out
    rows = sparse_rows(support.d, support.max_row)
    if rows == 0:
        raise ValueError(f"a row of {support.max_row} nonzeros over "
                         f"{support.d} features does not fit the sparse "
                         f"kernel's shared memory")
    err = _build.library().repro_pairwise_sparse_panel(
        support.offsets.data_ptr(), support.indices.data_ptr(),
        support.values.data_ptr(), out.data_ptr(), row0, bm, n, support.d,
        rows, sparse_slots(rows, support.max_row),
        _build.stream_handle(out.device))
    _build.launches["pairwise_sparse_panel"] += 1
    if _build.recorder is not None:
        _build.recorder("pairwise_sparse_panel",
                        *sparse_cost(bm, n, support.nnz, rows))
    _build.check(err, "pairwise_sparse_panel")
    return out
