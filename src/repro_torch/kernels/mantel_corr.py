"""Launch of the batched permuted square multiply-reduce CUDA kernels
(``csrc/mantel_corr.cu``).

Replaces the Pallas kernel ``repro/kernels/mantel_corr.py::mantel_corr``
and the XLA row and column gathers its wrapper runs before it.
Row-stationary: each block holds a row r of x in shared memory for all B
permutations of the launch and, for each, streams ŷ row ``inv[b, r]`` and
the 16-bit order row, gathering ``x_row[o_b[j]]`` (``mantel_corr_partials``,
one fp64 partial per (block, b)); a second kernel sums the partials over
the blocks in a fixed order (``mantel_corr_finish``). No float atomics, so
the result is bitwise reproducible. The inverse and 16-bit orders come
from ``inverse_orders``, which refuses orders that are not permutations.

Column-range mode (``c0``), for the distributed Mantel test: ŷ is the
(n, c) block of the square's columns [c0, c0 + c), and the sum runs over
those columns only. The square call is c0 = 0, c = n and keeps its bits.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.inverse_orders import inverse_orders

#: shared memory a block may opt into on an H100 (227 KB).
MAX_SHARED_BYTES = 232448
#: widest x whose fp32 row fits in a block's shared memory.
MAX_N = MAX_SHARED_BYTES // 4
#: permutations a launch: four fp64 slots a lane.
MAX_PERMS = 128


def mantel_corr_partials(x: torch.Tensor, yhat: torch.Tensor,
                         inv: torch.Tensor, orders16: torch.Tensor,
                         c0: int = 0) -> torch.Tensor:
    """(blocks, B) fp64 partials of ``Σ_i Σ_{j∈[c0, c0+c)} x[o_b[i],
    o_b[j]]·ŷ[i, j − c0]``, one per block of the launch (as many as the
    card holds at once, at most n).

    x: (n, n) fp32; yhat: (n, c) fp32, the square's columns [c0, c0 + c)
    (the square itself: c = n, c0 = 0); inv: (B, n) int32 inverse orders
    and orders16: (B, n) the 16-bit orders (both from ``inverse_orders``);
    all contiguous on one CUDA device, 1 <= n <= MAX_N, B <= MAX_PERMS.
    Returns without synchronising.
    """
    perms, n = inv.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"mantel_corr takes 1 <= n <= {MAX_N} (a row of x "
                         f"must fit in shared memory), got n={n}")
    if perms > MAX_PERMS:
        raise ValueError(f"one launch takes {MAX_PERMS} permutations, got "
                         f"{perms}")
    cols = yhat.shape[1]
    if yhat.shape[0] != n or not (0 <= c0 and c0 + cols <= n):
        raise ValueError(f"yhat must be columns [c0, c0 + c) of an ({n}, "
                         f"{n}) square, got {tuple(yhat.shape)} at c0={c0}")
    grid = _build.resident_grid("repro_mantel_corr_grid", n, perms)
    partials = torch.empty((grid, perms), dtype=torch.float64,
                           device=x.device)
    err = _build.library().repro_mantel_corr_partials(
        x.data_ptr(), yhat.data_ptr(), inv.data_ptr(), orders16.data_ptr(),
        partials.data_ptr(), n, cols, c0, perms, grid,
        _build.stream_handle(x.device))
    _build.launches["mantel_corr"] += 1
    _build.check(err, "mantel_corr")
    return partials


def mantel_corr_finish(partials: torch.Tensor) -> torch.Tensor:
    """(B,) fp32 sums over the block axis of (blocks, B) fp64 partials, in
    a fixed order. Returns without synchronising."""
    rows, perms = partials.shape
    out = torch.empty((perms,), dtype=torch.float32, device=partials.device)
    err = _build.library().repro_mantel_corr_finish(
        partials.data_ptr(), out.data_ptr(), rows, perms,
        _build.stream_handle(partials.device))
    _build.launches["mantel_corr_finish"] += 1
    _build.check(err, "mantel_corr_finish")
    return out


def mantel_corr(x: torch.Tensor, yhat: torch.Tensor, orders: torch.Tensor,
                c0: int = 0) -> torch.Tensor:
    """stats[b] = Σ_i Σ_{j∈[c0, c0+c)} x[o_b[i], o_b[j]]·ŷ[i, j − c0] on
    the card, (B,) fp32, for ŷ the (n, c) columns from c0 (the square:
    c0 = 0, c = n). Refuses orders that are not permutations (one
    ``inverse_orders`` launch and a sync); above ``MAX_PERMS`` permutations
    it runs in slabs, each one launch pair."""
    inv, orders16 = inverse_orders(orders)
    return torch.cat([
        mantel_corr_finish(mantel_corr_partials(
            x, yhat, inv[b0:b0 + MAX_PERMS], orders16[b0:b0 + MAX_PERMS],
            c0))
        for b0 in range(0, orders.shape[0], MAX_PERMS)])
