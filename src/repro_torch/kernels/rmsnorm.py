"""Launch of the fused RMSNorm CUDA kernels (``csrc/rmsnorm.cu``).

The forward replaces the Pallas kernel ``repro/kernels/rmsnorm.py::rmsnorm``.
One warp owns a row at d <= 256 (the qk-norm width), one block above it;
the statistic is summed in fp32 in a fixed order and the output rounded
once, so two launches give the same bits. It can also write each row's
inverse RMS, which the backward reads.

The backward is new (the reference differentiates its jnp ``rmsnorm``):
``rmsnorm_backward`` is one cooperative launch of ``rmsnorm_bwd`` over a
grid fixed by (rows, d) (:func:`bwd_grid`): each block writes dx and one
row of fp32 dw partials, then, after a grid-wide barrier, sums the partials
of its columns in fp64 in a fixed order, so two launches give the same
bits.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import require

#: the kernel's dtype codes for x, out and w.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: rows a launch takes: one block (or warp) a row, a grid of < 2^31 blocks.
MAX_ROWS = 2**31 - 1
#: widest row one warp owns (the forward's and the backward's warp route).
WARP_MAX_D = 256
#: widest row of the backward: its block route keeps d fp32 dw sums in the
#: 227 KB of shared memory a block may opt into.
MAX_BWD_D = 56 * 1024
#: the backward's grid: at most this many blocks, the SMs of the PCIe H100
#: (132 on the SXM card), so that the cooperative launch is resident on
#: either; each block takes at least BWD_MIN_ROWS[route] rows ("warp" at
#: d <= 256, "block" above).
BWD_MAX_BLOCKS = 114
BWD_MIN_ROWS = {"warp": 64, "block": 4}


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float,
            inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(rows, d) RMSNorm of ``x`` with the '1 + w' scale, in x's dtype.

    x: (rows, d) fp32 or bf16; w: (d,) fp32 or bf16; both contiguous on one
    CUDA device, rows <= MAX_ROWS. ``inv``, when given, is a (rows,) fp32
    tensor that receives each row's inverse RMS. Returns without
    synchronising."""
    rows, d = x.shape
    if rows > MAX_ROWS:
        raise ValueError(f"rmsnorm takes at most {MAX_ROWS} rows a launch, "
                         f"got {rows}")
    if inv is not None and (inv.dtype != torch.float32
                            or tuple(inv.shape) != (rows,)):
        raise ValueError(f"inv must be a ({rows},) float32 tensor")
    out = torch.empty_like(x)
    err = _build.library().repro_rmsnorm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if inv is None else inv.data_ptr(), rows, d,
        DTYPE_CODES[x.dtype], DTYPE_CODES[w.dtype], eps,
        _build.stream_handle(x.device))
    _build.launches["rmsnorm"] += 1
    _build.check(err, "rmsnorm")
    return out


def bwd_grid(rows: int, d: int) -> tuple[int, int]:
    """``(blocks, rows_per_block)`` of the backward at (rows, d): a function
    of the shape alone, so the dw partials are summed in the same order on
    every launch. Block b takes rows [b·rows_per_block, (b+1)·rows_per_block).
    """
    least = BWD_MIN_ROWS["warp" if d <= WARP_MAX_D else "block"]
    blocks = max(1, min(rows // least, BWD_MAX_BLOCKS))
    per_block = -(-rows // blocks)
    return -(-rows // per_block), per_block


def rmsnorm_backward(x: torch.Tensor, w: torch.Tensor, inv: torch.Tensor,
                     dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of the '1 + w' RMSNorm at (x, w) for the output
    gradient ``dy``, one launch: dx (rows, d) in x's dtype, dw (d,) in w's.

    x, dy: (rows, d) of one dtype; w: (d,); inv: (rows,) fp32, the
    forward's inverse RMS; all contiguous on one CUDA device, 1 <= d <=
    MAX_BWD_D. Returns without synchronising."""
    rows, d = x.shape
    if rows > MAX_ROWS:
        raise ValueError(f"rmsnorm_bwd takes at most {MAX_ROWS} rows a "
                         f"launch, got {rows}")
    if not 1 <= d <= MAX_BWD_D:
        raise ValueError(f"rmsnorm_bwd takes 1 <= d <= {MAX_BWD_D}, got {d}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
    require(x, "x", x.dtype)
    require(w, "w", w.dtype, (d,))
    require(dy, "dy", x.dtype, (rows, d))
    require(inv, "inv", torch.float32, (rows,))
    blocks, per_block = bwd_grid(rows, d)
    dx = torch.empty_like(x)
    dw = torch.empty((d,), dtype=w.dtype, device=x.device)
    partials = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    err = _build.library().repro_rmsnorm_bwd(
        x.data_ptr(), w.data_ptr(), inv.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), partials.data_ptr(), dw.data_ptr(), rows, d,
        per_block, DTYPE_CODES[x.dtype], DTYPE_CODES[w.dtype],
        _build.stream_handle(x.device))
    _build.launches["rmsnorm_bwd"] += 1
    _build.check(err, "rmsnorm_bwd")
    return dx, dw
