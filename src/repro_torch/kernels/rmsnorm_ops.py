"""Public wrapper for the fused RMSNorm kernels, forward and backward.

The counterpart of ``repro/kernels/rmsnorm_ops.py::rmsnorm_pallas``: RMSNorm
over the last axis of an ``x`` of any rank, flattened to (rows, d). On a
CUDA tensor it is one launch of the ``rmsnorm`` kernel; on a CPU tensor
the plain version runs. Nothing is padded (the reference pads the rows to
its 64-row blocks for the TPU).

When autograd records the call (grad mode on and ``x`` or ``w`` requiring a
gradient) it goes through :class:`RMSNormFunction`: on a CUDA tensor the
forward kernel also writes each row's inverse RMS, and the backward is one
launch of the ``rmsnorm_bwd`` kernel; on a CPU tensor the
forward and the backward are the plain versions. Neither falls back to the
other device's route, nor to a library norm.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import same_device
from repro_torch.kernels.rmsnorm import DTYPE_CODES, rmsnorm, rmsnorm_backward
from repro_torch.kernels.rmsnorm_ref import (rmsnorm_backward_plain,
                                             rmsnorm_plain)


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm of a (rows, d) ``x`` whose backward is a kernel too. It saves
    x, w and, on the card, the forward's inverse RMS of each row."""

    @staticmethod
    def forward(ctx, x, w, eps):
        if x.device.type == "cpu":
            out, inv = rmsnorm_plain(x, w, eps), None
        else:
            inv = torch.empty((x.shape[0],), dtype=torch.float32,
                              device=x.device)
            out = rmsnorm(x, w, eps, inv)
        ctx.save_for_backward(x, w, inv)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w, inv = ctx.saved_tensors
        dout = dout.contiguous()
        if x.device.type == "cpu":
            dx, dw = rmsnorm_backward_plain(x, w, dout, ctx.eps)
        else:
            dx, dw = rmsnorm_backward(x, w, inv, dout)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None, None)


def rmsnorm_op(x: torch.Tensor, w: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """``(x · rsqrt(mean(x²) + eps) · (1 + w)).to(x.dtype)`` over the last
    axis, statistics in fp32. x: (..., d) fp32 or bf16; w: (d,) fp32 or
    bf16, on x's device. Differentiable in x and w."""
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"w must have shape ({d},), got {tuple(w.shape)}")
    device = same_device(x, w)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        out = RMSNormFunction.apply(x.reshape(-1, d).contiguous(),
                                    w.contiguous(), eps)
        return out.view(x.shape)
    if device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    out = rmsnorm(x.reshape(-1, d).contiguous(), w.contiguous(), eps)
    return out.view(x.shape)
