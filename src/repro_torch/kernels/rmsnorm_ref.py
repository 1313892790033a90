"""Plain PyTorch version of the fused RMSNorm kernel.

``rmsnorm_plain`` is ``repro/kernels/rmsnorm_ref.py::rmsnorm_ref``: fp32
mean of x², ``y = x · rsqrt(ms + eps)``, ``(y · (1 + w)).to(x.dtype)``,
rounded once. The CPU path runs it; the card's kernel is held against it.

``bf16_ulp_distance`` counts the bf16 values between two bf16 tensors,
elementwise: the unit of the kernel's bf16 tolerance.
"""

from __future__ import annotations

import torch


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` with the '1 + w' scale."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def bf16_ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a − b| in bf16 units in the last place, as int32, elementwise.

    The bit patterns are mapped to integers that are monotonic in the
    value (+0 and −0 both to 0), so adjacent bf16 values differ by 1."""
    def ordinal(t: torch.Tensor) -> torch.Tensor:
        bits = t.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordinal(a) - ordinal(b)).abs()
