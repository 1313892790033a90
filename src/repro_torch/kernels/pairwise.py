"""Launch of the pairwise-panel CUDA kernel (``csrc/pairwise.cu``).

Replaces the Pallas kernel ``repro/kernels/pairwise.py::pairwise_panel``.
A block owns a 64 × 64 tile of the (bm, n) panel and loops over the
features itself, 32 at a time, staging both operands' tiles in shared
memory; each thread keeps a 4 × 4 patch of the metric's accumulators in
registers and writes each finished distance once. Ragged bm, n and d are
masked in the kernel, so nothing is padded.
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


def pairwise_cost(bm: int, n: int, d: int, kind: int) -> tuple[float, float]:
    """(bytes, operations) of one ``pairwise_panel`` launch: the block of
    each (64-row, 64-column) tile reads its xi rows and its x rows over all
    d features, so xi is read ceil(n / 64) times and x ceil(bm / 64) times
    (ragged rows masked, never loaded); each distance is stored once."""
    loads = 4.0 * d * (-(-n // TILE) * bm + -(-bm // TILE) * n)
    return loads + 4.0 * bm * n, float(TERM_OPERATIONS[kind]) * bm * n * d


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
