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
    _build.check(err, "pairwise_panel")
    return out
