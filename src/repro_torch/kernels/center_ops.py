"""Public wrappers for the two-pass centering kernels.

The counterpart of ``repro/kernels/center_ops.py``. Each checks its
operands and dispatches: on a CUDA tensor the kernels of ``csrc/center.cu``
(pass 1, the fixed-order finish, pass 2), on a CPU tensor their plain
versions. They take fp32 and bf16, as the reference's wrapper does. The
kernels mask a ragged n themselves, so nothing is padded (the reference
pads n to its blocks) and there are no block sizes to choose.

``center_distance_matrix_op`` centres a square matrix. The three steps
are public for the distributed centering, whose ranks each hold an
(r, c) block: ``center_row_sums_op`` (pass 1 of a block),
``center_means_op`` (the finish, on all n row sums) and
``center_block_op`` (pass 2 of a block, its row and column means apart).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.center import (center_finish, center_pass1,
                                        center_pass2)
from repro_torch.kernels.center_ref import (center_finish_ref,
                                            center_pass1_ref,
                                            center_pass2_ref)
from repro_torch.kernels.dispatch import require, same_device

DTYPES = (torch.float32, torch.bfloat16)


def _check_block(d: torch.Tensor) -> torch.device:
    if d.ndim != 2:
        raise ValueError(f"expected a matrix, got {tuple(d.shape)}")
    if d.dtype not in DTYPES:
        raise TypeError(f"d must be float32 or bfloat16, got {d.dtype}")
    if not d.is_contiguous():
        raise ValueError("d must be contiguous")
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {d.device}")
    return d.device


def center_row_sums_op(d: torch.Tensor) -> torch.Tensor:
    """(r,) fp32 row sums of ``E = −½ d∘d`` for an (r, c) block."""
    if _check_block(d).type == "cpu":
        return center_pass1_ref(d)
    return center_pass1(d)


def center_means_op(row_sums: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(row_means (n,), global_mean (1,))`` of E from all n of its fp32
    row sums, the global sum taken in a fixed order in fp64."""
    require(row_sums, "row_sums", torch.float32, (row_sums.shape[0],))
    if row_sums.device.type == "cpu":
        return center_finish_ref(row_sums)
    return center_finish(row_sums)


def center_block_op(d: torch.Tensor, row_means: torch.Tensor,
                    col_means: torch.Tensor,
                    global_mean: torch.Tensor) -> torch.Tensor:
    """F = E − r_i − c_j + m for an (r, c) block, in ``d``'s dtype, given
    its fp32 row means (r,), column means (c,) and global mean (1,)."""
    rows, cols = d.shape
    _check_block(d)
    require(row_means, "row_means", torch.float32, (rows,))
    require(col_means, "col_means", torch.float32, (cols,))
    require(global_mean, "global_mean", torch.float32, (1,))
    if same_device(d, row_means, col_means, global_mean).type == "cpu":
        return center_pass2_ref(d, row_means, global_mean, col_means)
    return center_pass2(d, row_means, global_mean, col_means)


def center_distance_matrix_op(d: torch.Tensor) -> torch.Tensor:
    """The Gower-centred F of a square distance matrix, in ``d``'s dtype."""
    if d.ndim != 2 or d.shape[0] != d.shape[1]:
        raise ValueError(f"expected a square matrix, got {tuple(d.shape)}")
    row_means, global_mean = center_means_op(center_row_sums_op(d))
    return center_block_op(d, row_means, row_means, global_mean)
