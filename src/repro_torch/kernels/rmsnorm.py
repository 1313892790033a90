"""Launch of the fused RMSNorm CUDA kernel (``csrc/rmsnorm.cu``).

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py::rmsnorm``. One warp
owns a row at d <= 256 (the qk-norm width), one block above it; the
statistic is summed in fp32 in a fixed order and the output rounded once,
so two launches give the same bits.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: the kernel's dtype codes for x, out and w.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: rows a launch takes: one block (or warp) a row, a grid of < 2^31 blocks.
MAX_ROWS = 2**31 - 1


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """(rows, d) RMSNorm of ``x`` with the '1 + w' scale, in x's dtype.

    x: (rows, d) fp32 or bf16; w: (d,) fp32 or bf16; both contiguous on one
    CUDA device, rows <= MAX_ROWS. Returns without synchronising.
    """
    rows, d = x.shape
    if rows > MAX_ROWS:
        raise ValueError(f"rmsnorm takes at most {MAX_ROWS} rows a launch, "
                         f"got {rows}")
    out = torch.empty_like(x)
    err = _build.library().repro_rmsnorm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d,
        DTYPE_CODES[x.dtype], DTYPE_CODES[w.dtype], eps,
        _build.stream_handle(x.device))
    _build.launches["rmsnorm"] += 1
    _build.check(err, "rmsnorm")
    return out
