"""Launch of the batched permuted square multiply-reduce CUDA kernels
(``csrc/mantel_corr.cu``).

Replaces the Pallas kernel ``repro/kernels/mantel_corr.py::mantel_corr``
and the XLA row and column gathers its wrapper runs before it. A block
owns one row i of ŷ, loops over the tile's permutations, stages row
``o_b[i]`` of x in shared memory and walks the row through the order
(``mantel_corr_partials``, one fp64 partial per (i, b)); a second kernel
sums the partials over the rows in a fixed order (``mantel_corr_finish``).
No float atomics, so the result is bitwise reproducible.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: shared memory a block may opt into on an H100 (227 KB).
MAX_SHARED_BYTES = 232448
#: widest x whose fp32 row fits beside the block's 16 fp64 warp sums.
MAX_N = (MAX_SHARED_BYTES - 16 * 8) // 4


def mantel_corr_partials(x: torch.Tensor, yhat: torch.Tensor,
                         orders: torch.Tensor) -> torch.Tensor:
    """(n, B) fp64 partials: ``Σ_j x[o_b[i], o_b[j]]·ŷ[i, j]`` per row i.

    x, yhat: (n, n) fp32; orders: (B, n) int32; all contiguous on one CUDA
    device, 1 <= n <= MAX_N. Returns without synchronising.
    """
    perms, n = orders.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"mantel_corr takes 1 <= n <= {MAX_N} (a row of x "
                         f"must fit in shared memory), got n={n}")
    partials = torch.empty((n, perms), dtype=torch.float64, device=x.device)
    err = _build.library().repro_mantel_corr_partials(
        x.data_ptr(), yhat.data_ptr(), orders.data_ptr(), partials.data_ptr(),
        n, perms, _build.stream_handle(x.device))
    _build.launches["mantel_corr"] += 1
    _build.check(err, "mantel_corr")
    return partials


def mantel_corr_finish(partials: torch.Tensor) -> torch.Tensor:
    """(B,) fp32 sums over the row axis of (n, B) fp64 partials, in a
    fixed order. Returns without synchronising."""
    rows, perms = partials.shape
    out = torch.empty((perms,), dtype=torch.float32, device=partials.device)
    err = _build.library().repro_mantel_corr_finish(
        partials.data_ptr(), out.data_ptr(), rows, perms,
        _build.stream_handle(partials.device))
    _build.launches["mantel_corr_finish"] += 1
    _build.check(err, "mantel_corr_finish")
    return out


def mantel_corr(x: torch.Tensor, yhat: torch.Tensor,
                orders: torch.Tensor) -> torch.Tensor:
    """stats[b] = Σ_ij x[o_b[i], o_b[j]]·ŷ[i, j] on the card, (B,) fp32."""
    return mantel_corr_finish(mantel_corr_partials(x, yhat, orders))
