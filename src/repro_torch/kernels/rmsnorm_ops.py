"""Public wrapper for the fused RMSNorm kernel.

The counterpart of ``repro/kernels/rmsnorm_ops.py::rmsnorm_pallas``: RMSNorm
over the last axis of an ``x`` of any rank, flattened to (rows, d). On a
CUDA tensor it is one launch of the ``rmsnorm`` kernel; on a CPU tensor
the plain version runs. Nothing is padded (the reference pads the rows to
its 64-row blocks for the TPU).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import same_device
from repro_torch.kernels.rmsnorm import DTYPE_CODES, rmsnorm
from repro_torch.kernels.rmsnorm_ref import rmsnorm_plain


def rmsnorm_op(x: torch.Tensor, w: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """``(x · rsqrt(mean(x²) + eps) · (1 + w)).to(x.dtype)`` over the last
    axis, statistics in fp32. x: (..., d) fp32 or bf16; w: (d,) fp32 or
    bf16, on x's device."""
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"w must have shape ({d},), got {tuple(w.shape)}")
    device = same_device(x, w)
    if device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = rmsnorm(x.reshape(-1, d).contiguous(), w.contiguous(), eps)
    return out.view(x.shape)
