"""Launch of the fused symmetric+hollow CUDA kernel (``csrc/symhollow.cu``).

Replaces the Pallas kernel ``repro/kernels/symhollow.py::symhollow``: one
read of the matrix, tile (i, j) compared with the transpose of its partner
(j, i) in shared memory, the diagonal checked on the diagonal tiles, two
int32 flags cleared with integer atomics. The source says what bounds it
and why it is built so.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def symhollow(mat: torch.Tensor) -> torch.Tensor:
    """int32[2] flags ``(is_sym, is_hollow)`` (1 = holds) of a square,
    contiguous fp32 CUDA matrix. Returns without synchronising."""
    n = mat.shape[0]
    flags = torch.ones(2, dtype=torch.int32, device=mat.device)
    if n == 0:
        return flags
    lib = _build.library()
    err = lib.repro_symhollow(mat.data_ptr(), n, flags.data_ptr(),
                              _build.stream_handle(mat.device))
    _build.launches["symhollow"] += 1
    _build.check(err, "symhollow")
    return flags
