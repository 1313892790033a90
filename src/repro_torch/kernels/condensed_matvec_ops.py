"""Public wrapper for the condensed centred-Gram product.

``F @ X`` over the condensed distances of a feature-table production,
F never formed. It hoists the O(k) correction vectors on the unpadded
operands and dispatches: the ``condensed_matvec`` kernel on a CUDA tensor
(X wider than its 128 columns in slabs of 128, a launch each), the plain
strip loop on a CPU tensor, whose ``block`` rows a strip it takes. n <= 1
has no pairs: zeros, and no launch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.center_matvec_ops import _slabs
from repro_torch.kernels.center_matvec_ref import center_corrections
from repro_torch.kernels.condensed_matvec import condensed_matvec
from repro_torch.kernels.condensed_matvec_ref import condensed_matvec_ref
from repro_torch.kernels.dispatch import require, same_device
from repro_torch.obs.compile import note_trace


def condensed_matvec_op(dc: torch.Tensor, x: torch.Tensor,
                        row_means: torch.Tensor, global_mean: torch.Tensor,
                        n: int, block: int = 256) -> torch.Tensor:
    """``F @ x`` with F never formed. dc: (n(n−1)/2,) condensed distances;
    x: (n, k); row_means and global_mean: the hoisted statistics of
    ``E = −½D∘D``; ``block``: rows a strip of the CPU route."""
    if x.ndim != 2 or x.shape[0] != n:
        raise ValueError(f"x must be ({n}, k), got {tuple(x.shape)}")
    require(dc, "dc", torch.float32, (n * (n - 1) // 2,))
    require(x, "x", torch.float32)
    require(row_means, "row_means", torch.float32, (n,))
    require(global_mean, "global_mean", torch.float32, ())
    device = same_device(dc, x, row_means, global_mean)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    note_trace("kernels.condensed_matvec",
               (n, x.shape[1], dc.dtype, device.type))
    if n <= 1:
        return torch.zeros((n, x.shape[1]), dtype=x.dtype, device=device)
    if device.type == "cpu":
        return condensed_matvec_ref(dc, x, row_means, global_mean, n, block)
    colsum, corr = center_corrections(x, row_means, global_mean)
    return _slabs(lambda xs, cs, cr: condensed_matvec(dc, xs, row_means, cs,
                                                      cr, n),
                  x, colsum, corr)
