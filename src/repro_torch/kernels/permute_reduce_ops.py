"""Public wrapper for the batched permuted gather-reduce.

The counterpart of ``repro/kernels/permute_reduce_ops.py::permute_reduce``,
with its contract: the ``n <= MAX_TRIANGLE_N`` int32 guard, the shape
checks on ``xc`` and ``ys``, and the empty (S, B) result for n < 2. Every
order row must be a permutation of 0..n−1 (``inverse_orders`` refuses the
tile otherwise, on either device). On a CPU tensor the plain version runs
chunk by chunk over the condensed stream: the triangle map ``(ii, jj)``
recomputed when the caller did not hoist it, the chunk geometry of
``snap_chunk``, and the reference's padding rule (padded ``ys`` = 0,
``ii`` = 0, ``jj`` = 1, so padded positions add exactly 0 and the dead
gather stays in range). On a CUDA tensor the row-stationary kernel reads
neither a triangle map nor chunks, so there the wrapper takes neither.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.distance_matrix import MAX_TRIANGLE_N, triangle_coords
from repro_torch.kernels.dispatch import require, same_device, snap_chunk
from repro_torch.kernels.inverse_orders import inverse_orders
from repro_torch.kernels.permute_reduce import permute_reduce_kernel
from repro_torch.kernels.permute_reduce_ref import permute_reduce_ref
from repro_torch.obs.compile import note_trace

#: condensed entries per chunk of the plain version: one (B, chunk) gather
#: tile on the CPU.
DEFAULT_CHUNK = 65536


def permute_reduce(xc: torch.Tensor, ys: torch.Tensor, orders: torch.Tensor,
                   ii: Optional[torch.Tensor] = None,
                   jj: Optional[torch.Tensor] = None, *,
                   chunk: Optional[int] = None) -> torch.Tensor:
    """All B permuted condensed multiply-reduces of one invariant stack.

    out[s, b] = Σ_k ys[s, k]·xc[tri(orders[b, i_k], orders[b, j_k])]
              = <condensed(X[orders[b]][:, orders[b]]), ys[s]>

    xc: (m,) condensed source, m = n(n−1)/2; ys: (S, m); orders: (B, n)
    integer permutations. On the CPU only: ii/jj, an optional hoisted
    ``triangle_coords``, and ``chunk``, the plain version's tile; a CUDA
    call that passes either raises. Returns (S, B) fp32.
    """
    perms, n = orders.shape
    if n > MAX_TRIANGLE_N:
        raise ValueError(
            f"permute_reduce supports n <= {MAX_TRIANGLE_N} (int32 triangle "
            f"indexing would overflow and silently corrupt the gather); "
            f"got n={n}")
    m = n * (n - 1) // 2
    if tuple(xc.shape) != (m,):
        raise ValueError(f"xc must be condensed length m={m} for n={n}, "
                         f"got {tuple(xc.shape)}")
    if ys.ndim != 2 or ys.shape[1] != m:
        raise ValueError(f"ys must be (S, {m}), got {tuple(ys.shape)}")
    require(xc, "xc", torch.float32)
    require(ys, "ys", torch.float32)
    device = same_device(xc, ys, orders)
    # one call of THE padded per_batch entry: one signature per (n, S, B)
    # whatever K the engine runs
    note_trace("kernels.permute_reduce",
               (n, ys.shape[0], perms, xc.dtype, device.type))
    if m == 0:                                     # n < 2: empty triangle
        return torch.zeros((ys.shape[0], perms), dtype=torch.float32,
                           device=device)
    if device.type == "cuda":
        if ii is not None or jj is not None or chunk is not None:
            raise ValueError("on the card permute_reduce reads no triangle "
                             "map and no chunk: pass neither ii/jj nor chunk")
        return permute_reduce_kernel(xc, ys, orders)
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    inverse_orders(orders)                         # refuse non-permutations
    if ii is None or jj is None:
        ii, jj = triangle_coords(n, device=device)
    orders = orders.to(torch.int32).contiguous()
    ii = ii.to(torch.int32)
    jj = jj.to(torch.int32)
    require(ii, "ii", torch.int32, (m,))
    require(jj, "jj", torch.int32, (m,))
    same_device(xc, ii, jj)
    chunk, m_pad = snap_chunk(m, DEFAULT_CHUNK if chunk is None
                              else int(chunk))
    pad = m_pad - m
    if pad:
        ys = F.pad(ys, (0, pad))
        ii = F.pad(ii, (0, pad))
        jj = F.pad(jj, (0, pad), value=1)
    return permute_reduce_ref(xc, ys, ii, jj, orders, n, chunk)
