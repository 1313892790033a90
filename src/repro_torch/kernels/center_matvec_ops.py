"""Public wrapper for the fused center-matvec kernel.

The counterpart of ``repro/kernels/center_matvec_ops.py``. It hoists the
O(k) correction vectors on the unpadded operands and dispatches: the CUDA
kernel on a CUDA tensor, the plain version on a CPU tensor. The kernel
masks a ragged n and k itself, so nothing is padded (the reference pads n
to its blocks and k to 128 lanes). An X wider than the kernel's 128
columns goes through in slabs of 128, each a launch that reads D again.

``block_product_op`` is the kernel's block mode for the distributed
matvec: ``E_blk @ X_col`` for one rank's (r, c) block of D, the kernel run
with zero means and corrections, so no block-sized E is ever formed. A
block has fewer 128-row strips than the square, so the kernel sweeps each
strip with a thread-block cluster (``sweep_split``: 2 blocks a strip at a
2 x 2 mesh's (8192, 8192) block), still one launch a call.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.center_matvec import KMAX, center_matvec
from repro_torch.kernels.center_matvec_ref import (center_corrections,
                                                   center_matvec_block_ref,
                                                   center_matvec_ref)
from repro_torch.kernels.dispatch import require, same_device
from repro_torch.obs.compile import note_trace


def center_matvec_op(d: torch.Tensor, x: torch.Tensor,
                     row_means: torch.Tensor,
                     global_mean: torch.Tensor) -> torch.Tensor:
    """``F @ x`` with F never formed. d: (n, n); x: (n, k); row_means and
    global_mean: the operator's hoisted statistics of ``E = −½D∘D``."""
    n = d.shape[0]
    if x.ndim != 2 or x.shape[0] != n:
        raise ValueError(f"x must be ({n}, k), got {tuple(x.shape)}")
    require(d, "d", torch.float32, (n, n))
    require(x, "x", torch.float32)
    require(row_means, "row_means", torch.float32, (n,))
    require(global_mean, "global_mean", torch.float32, ())
    device = same_device(d, x, row_means, global_mean)
    note_trace("kernels.center_matvec",
               (n, x.shape[1], d.dtype, device.type))
    if device.type == "cpu":
        return center_matvec_ref(d, x, row_means, global_mean)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    colsum, corr = center_corrections(x, row_means, global_mean)
    return _slabs(lambda xs, cs, cr: center_matvec(d, xs, row_means, cs, cr),
                  x, colsum, corr)


def _slabs(launch, x: torch.Tensor, *per_column: torch.Tensor
           ) -> torch.Tensor:
    """``launch(x, *per_column)`` over slabs of at most KMAX columns."""
    k = x.shape[1]
    if k <= KMAX:
        return launch(x, *per_column)
    return torch.cat([
        launch(x[:, c:c + KMAX].contiguous(),
               *(v[c:c + KMAX].contiguous() for v in per_column))
        for c in range(0, k, KMAX)], dim=1)


def block_product_op(d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(r, k) ``E@X`` with ``E = −½ d∘d`` for an (r, c) block ``d`` and a
    (c, k) ``x``, E never formed: the ``center_matvec`` kernel with zero
    row means, column sums and corrections on the card, its plain version
    on the CPU."""
    rows, cols = d.shape
    if x.ndim != 2 or x.shape[0] != cols:
        raise ValueError(f"x must be ({cols}, k), got {tuple(x.shape)}")
    require(d, "d", torch.float32, (rows, cols))
    require(x, "x", torch.float32)
    device = same_device(d, x)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    zero_rows = torch.zeros((rows,), dtype=torch.float32, device=device)
    zero_k = torch.zeros((x.shape[1],), dtype=torch.float32, device=device)
    if device.type == "cpu":
        return center_matvec_block_ref(d, x, zero_rows, zero_k, zero_k)
    return _slabs(lambda xs, z: center_matvec(d, xs, zero_rows, z, z),
                  x, zero_k)
