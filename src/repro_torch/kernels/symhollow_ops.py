"""Public wrapper for the fused validation kernel.

The counterpart of ``repro/kernels/symhollow_ops.py``. On a CUDA tensor it
launches the kernel, which masks a ragged n itself: the reference's
zero-padded copy (an extra n² write) is not made. On a CPU tensor it runs
the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import require
from repro_torch.kernels.symhollow import symhollow
from repro_torch.kernels.symhollow_ref import is_symmetric_and_hollow_ref


def is_symmetric_and_hollow_op(mat: torch.Tensor) -> tuple[bool, bool]:
    """``(is_sym, is_hollow)`` of a square fp32 matrix in one pass."""
    if mat.ndim != 2 or mat.shape[0] != mat.shape[1]:
        raise ValueError(f"expected a square 2-D matrix, got "
                         f"{tuple(mat.shape)}")
    require(mat, "mat", torch.float32)
    if mat.device.type == "cpu":
        return is_symmetric_and_hollow_ref(mat)
    if mat.device.type != "cuda":
        raise ValueError(f"unsupported device {mat.device}")
    is_sym, is_hollow = symhollow(mat).tolist()
    return is_sym == 1, is_hollow == 1
