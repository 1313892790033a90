"""Public wrapper for the two-pass centering kernels.

The counterpart of ``repro/kernels/center_ops.py``. It checks the operand
and dispatches: on a CUDA tensor the kernels of ``csrc/center.cu`` (pass 1,
the fixed-order finish, pass 2), on a CPU tensor their plain version. It
takes fp32 and bf16, as the reference's wrapper does. The kernels mask a
ragged n themselves, so nothing is padded (the reference pads n to its
blocks) and there are no block sizes to choose.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.center import (center_finish, center_pass1,
                                        center_pass2)
from repro_torch.kernels.center_ref import center_two_pass_ref

DTYPES = (torch.float32, torch.bfloat16)


def center_distance_matrix_op(d: torch.Tensor) -> torch.Tensor:
    """The Gower-centred F of a square distance matrix, in ``d``'s dtype."""
    if d.ndim != 2 or d.shape[0] != d.shape[1]:
        raise ValueError(f"expected a square matrix, got {tuple(d.shape)}")
    if d.dtype not in DTYPES:
        raise TypeError(f"d must be float32 or bfloat16, got {d.dtype}")
    if not d.is_contiguous():
        raise ValueError("d must be contiguous")
    if d.device.type == "cpu":
        return center_two_pass_ref(d)
    if d.device.type != "cuda":
        raise ValueError(f"unsupported device {d.device}")
    row_means, global_mean = center_finish(center_pass1(d))
    return center_pass2(d, row_means, global_mean)
