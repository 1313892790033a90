"""Launch of the batched permuted gather-reduce CUDA kernels
(``csrc/permute_reduce.cu``).

Replaces the Pallas kernel
``repro/kernels/permute_reduce.py::permute_reduce_kernel``. Row-stationary:
each block holds a row r of the square x (its condensed run and its column
down the triangle) in shared memory for all B permutations of the tile and,
for each, streams the run of ys row ``inv[b, r]`` and the order row past it,
so ys is read once per permutation, coalesced, and xc once a tile
(``permute_reduce_partials``, one fp64 partial per (block, s, b)); a
second kernel sums the partials over the blocks in a fixed order
(``permute_reduce_finish``). No float atomics, so the result is bitwise
reproducible. The inverse and 16-bit orders come from
``inverse_orders``; the ii/jj triangle maps are not read.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.inverse_orders import (cluster_size,
                                                inverse_orders,
                                                inverse_orders_cost)

#: invariant rows one launch reduces against the same staged x rows
#: (Mantel streams 1, partial Mantel 2).
MAX_ROWS = 2
#: outputs (rows × permutations) a launch: four fp64 slots a lane.
MAX_OUTPUTS = 128
#: warps of a partials block (``kWarps``), each holding an fp64 partial of
#: every output of the launch until the block sums them
WARPS = 16


def perms_per_launch(rows: int, perms: int) -> int:
    """P, the permutations a launch takes of a tile of ``perms`` with
    ``rows`` invariant rows: MAX_OUTPUTS / min(rows, MAX_ROWS), at most B."""
    return max(min(perms, MAX_OUTPUTS // min(rows, MAX_ROWS)), 1)


def shared_bytes(n: int, rows: int, perms: int) -> int:
    """Dynamic shared memory of a partials block (``shared_bytes``): a row
    of x, or the warps' fp64 partials of the launch's outputs."""
    return max(4 * n, WARPS * 8 * rows * perms)


def resident_blocks(n: int, rows: int, perms: int) -> int:
    """Blocks of a partials launch: what the card holds at once, <= n."""
    return _build.resident_grid("repro_permute_reduce_grid", n, rows, perms)


def partials_cost(n: int, rows: int, perms: int, grid: int
                  ) -> tuple[float, float]:
    """(bytes, operations) of one ``permute_reduce_partials`` launch. Each
    row r of x is staged from its run and its column: the condensed x
    twice a launch, 2m floats (the column loads mostly from L2). For each
    permutation b the block streams the run of each ys row past i =
    inv[b, r] and the 16-bit orders past i: over the rows, m floats of
    each ys row and m order values a permutation, and one inv entry a
    (row, permutation). One fp64 partial is stored a (block, ys row,
    permutation); one fp64 multiply-add a (pair, ys row, permutation)."""
    m = n * (n - 1) // 2
    loads = 4.0 * m * (2 + rows * perms) + 2.0 * m * perms + 4.0 * n * perms
    return loads + 8.0 * grid * rows * perms, 2.0 * m * rows * perms


def finish_cost(num_chunks: int, outputs: int) -> tuple[float, float]:
    """(bytes, operations) of one ``permute_reduce_finish`` launch: every
    fp64 partial read once, one fp32 sum stored an output."""
    return 8.0 * num_chunks * outputs + 4.0 * outputs, \
        float(num_chunks * outputs)


def tile_cost(n: int, rows: int, perms: int, grid: int
              ) -> tuple[float, float]:
    """(bytes, operations) the launches of one :func:`permute_reduce_kernel`
    call declare: the tile's ``inverse_orders``, and for each slab a
    partials launch on ``grid`` blocks and its finish."""
    nbytes, ops = inverse_orders_cost(perms, n, cluster_size(perms, n))
    step = perms_per_launch(rows, perms)
    for s0 in range(0, rows, MAX_ROWS):
        for b0 in range(0, perms, step):
            s, p = min(MAX_ROWS, rows - s0), min(step, perms - b0)
            for cost in (partials_cost(n, s, p, grid),
                         finish_cost(grid, s * p)):
                nbytes, ops = nbytes + cost[0], ops + cost[1]
    return nbytes, ops


def permute_reduce_partials(xc: torch.Tensor, ys: torch.Tensor,
                            inv: torch.Tensor,
                            orders16: torch.Tensor) -> torch.Tensor:
    """(blocks, S, B) fp64 partial sums of the gather-reduce, one per block
    of the launch (as many as the card holds at once, at most n).

    xc: (m,) fp32; ys: (S, m) fp32 with 1 <= S <= MAX_ROWS, S·B <=
    MAX_OUTPUTS; inv: (B, n) int32 inverse orders and orders16: (B, n) the
    16-bit orders (both from ``inverse_orders``); all contiguous on one
    CUDA device, 2 <= n <= 46340. Returns without synchronising.
    """
    rows, m = ys.shape
    perms, n = inv.shape
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"one launch takes 1..{MAX_ROWS} rows, got {rows}")
    if rows * perms > MAX_OUTPUTS:
        raise ValueError(f"one launch takes {MAX_OUTPUTS} rows x "
                         f"permutations, got {rows} x {perms}")
    grid = resident_blocks(n, rows, perms)
    partials = torch.empty((grid, rows, perms), dtype=torch.float64,
                           device=xc.device)
    err = _build.library().repro_permute_reduce_partials(
        xc.data_ptr(), ys.data_ptr(), ys.stride(0), inv.data_ptr(),
        orders16.data_ptr(), partials.data_ptr(), n, rows, perms, grid,
        _build.stream_handle(xc.device))
    _build.launches["permute_reduce"] += 1
    if _build.recorder is not None:
        _build.recorder("permute_reduce",
                        *partials_cost(n, rows, perms, grid))
    _build.check(err, "permute_reduce")
    return partials


def permute_reduce_finish(partials: torch.Tensor) -> torch.Tensor:
    """(S, B) fp32 sums over the block axis of (blocks, S, B) fp64
    partials, in a fixed order. Returns without synchronising."""
    num_chunks, rows, perms = partials.shape
    out = torch.empty((rows, perms), dtype=torch.float32,
                      device=partials.device)
    err = _build.library().repro_permute_reduce_finish(
        partials.data_ptr(), out.data_ptr(), num_chunks, rows * perms,
        _build.stream_handle(partials.device))
    _build.launches["permute_reduce_finish"] += 1
    if _build.recorder is not None:
        _build.recorder("permute_reduce_finish",
                        *finish_cost(num_chunks, rows * perms))
    _build.check(err, "permute_reduce_finish")
    return out


def permute_reduce_kernel(xc: torch.Tensor, ys: torch.Tensor,
                          orders: torch.Tensor) -> torch.Tensor:
    """out[s, b] = Σ_{i<j} ys[s, tri(i, j)]·xc[tri(o_b[i], o_b[j])] on the
    card, (S, B) fp32. Refuses orders that are not permutations (one
    ``inverse_orders`` launch and a sync); S above ``MAX_ROWS``, or S·B
    above ``MAX_OUTPUTS``, runs in slabs, each one launch pair."""
    inv, orders16 = inverse_orders(orders)
    rows, perms = ys.shape[0], orders.shape[0]
    step = perms_per_launch(rows, perms)
    return torch.cat([
        torch.cat([permute_reduce_finish(permute_reduce_partials(
            xc, ys[s0:s0 + MAX_ROWS], inv[b0:b0 + step],
            orders16[b0:b0 + step])) for b0 in range(0, perms, step)], dim=1)
        for s0 in range(0, rows, MAX_ROWS)])
