"""Plain PyTorch versions of the fused RMSNorm kernels.

``rmsnorm_plain`` is ``repro/kernels/rmsnorm_ref.py::rmsnorm_ref``: fp32
mean of x², ``y = x · rsqrt(ms + eps)``, ``(y · (1 + w)).to(x.dtype)``,
rounded once. The CPU path runs it; the card's kernel is held against it.

``rmsnorm_backward_plain`` is the backward kernel's formula written step by
step (``csrc/rmsnorm.cu``): with w' = 1 + w, g = dy · w' and r the inverse
RMS, ``dx = r·g − x·c`` with ``c = r³·Σ g·x / d`` (the row sum in fp64,
c rounded to fp32) and ``dw = Σ_rows (dy·x)·r`` (summed in fp64). The CPU
path's autograd runs it; the card's backward is held against it.

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


def rms_inverse_plain(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The inverse RMS ``rsqrt(mean(x²) + eps)`` of each row of ``x``, in
    fp32, shape ``x.shape[:-1]``: the statistic ``rmsnorm_plain`` scales by."""
    xf = x.float()
    return torch.rsqrt(torch.mean(xf * xf, dim=-1) + eps)


def rmsnorm_backward_plain(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                           eps: float = 1e-6,
                           inv: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of ``rmsnorm_plain(x, w, eps)`` for the output gradient
    ``dy``: dx in x's dtype and shape, dw (d,) in w's dtype. ``inv`` is the
    forward's inverse RMS of each row (``x.shape[:-1]``), computed here when
    not given."""
    d = x.shape[-1]
    xf = x.float()
    r = (rms_inverse_plain(x, eps) if inv is None
         else inv.reshape(x.shape[:-1])).unsqueeze(-1)
    dyf = dy.float()
    g = dyf * (1.0 + w.float())
    dot = (g.double() * xf.double()).sum(dim=-1, keepdim=True)
    r64 = r.double()
    coef = (r64 * r64 * r64 * dot / d).float()
    dx = r * g - xf * coef
    dw = ((dyf * xf) * r).double().reshape(-1, d).sum(dim=0).float()
    return dx.to(x.dtype), dw.to(w.dtype)


def bf16_ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a − b| in bf16 units in the last place, as int32, elementwise.

    The bit patterns are mapped to integers that are monotonic in the
    value (+0 and −0 both to 0), so adjacent bf16 values differ by 1."""
    def ordinal(t: torch.Tensor) -> torch.Tensor:
        bits = t.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordinal(a) - ordinal(b)).abs()
