"""Gradient compression with error feedback for cross-pod sync.

The counterpart of ``repro/optim/compression.py``. Cross-pod links are the
scarcest bandwidth tier; the mitigation is a quantized gradient exchange
with an error-feedback accumulator (the quantization residual is replayed
into the next step, so the expected update is unbiased):

* ``compressed_psum(..., bits=16)`` — a bf16 exchange;
* ``compressed_psum(..., bits=8)``  — int8 with one fp32 scale a tensor.

The reference runs inside ``shard_map`` with ``axis_name`` bound; the port
has no ``shard_map``, so ``compressed_psum`` takes the mesh and the axis,
as ``launch.mesh.psum`` does, and every rank of the axis calls it with its
own gradients (ROADMAP.md, queue 3). Each peer's payload is gathered and
summed in rank order, so every rank holds the same bits: the int8 sum is
Σ_p q_p·scale_p over the gathered int8 values and scales of each peer, as
the reference reconstructs it, and the bf16 sum is taken in bf16.
"""

from __future__ import annotations

import torch

from repro_torch.launch import mesh as mesh_mod


def quantize_int8(x: torch.Tensor):
    """→ (q int8, scale fp32 0-d): ``scale = max(max|x|, 1e-12) / 127``,
    q = clip(round(x / scale), ±127) (round half to even, as jnp.round)."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(grads: dict) -> dict:
    """Zero fp32 residuals beside each gradient."""
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def compressed_psum(grads: dict, error_state: dict, mesh, axis_name: str,
                    bits: int = 8):
    """The mean of ``grads`` (``{name: tensor}``) over the ranks of
    ``axis_name`` on ``mesh``, exchanged at ``bits`` (8 or 16) with error
    feedback. Returns ``(synced fp32, new error state)``."""
    if bits not in (8, 16):
        raise ValueError(f"bits must be 8 or 16, got {bits}")
    n = mesh_mod.axis_size(mesh, axis_name)
    synced, new_err = {}, {}
    for name, g in grads.items():
        gf = g.to(torch.float32) + error_state[name]
        if bits == 8:
            q, scale = quantize_int8(gf)
            sent = dequantize_int8(q, scale)
            qs = mesh_mod.gather_stack(q, mesh, axis_name).to(torch.float32)
            scales = mesh_mod.gather_stack(scale, mesh, axis_name)
            total = qs[0] * scales[0]
            for p in range(1, n):
                total = total + qs[p] * scales[p]
            synced[name] = total / n
        else:
            sent = gf.to(torch.bfloat16).to(torch.float32)
            total = mesh_mod.psum(gf.to(torch.bfloat16), mesh, axis_name)
            synced[name] = total.to(torch.float32) / n
        new_err[name] = gf - sent
    return synced, new_err
