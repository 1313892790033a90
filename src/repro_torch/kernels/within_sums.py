"""Launch of the within-group rank sum CUDA kernels
(``csrc/within_sums.cu``).

ANOSIM's null loop: ``out[b] = Σ_{i<j} ranks[tri(i, j)]·[codes[o_b[i]] ==
codes[o_b[j]]]`` for a (B, n) tile of orders. Replaces no Pallas kernel:
the reference gathers an m-long within-group indicator through
``permute_reduce``, which the port keeps for the Mantel family. Here a
persistent block walks 128 x 128 tiles of the pairs' triangle, stages each
tile's ranks (doubled to exact integers) and the tile's permuted codes in
shared memory, and each lane of a warp sums one permutation's matching
pairs in 64-bit integers (``within_sums_partials``, one partial per
(block, permutation)); a second kernel sums the partials over the blocks
and halves them to fp32 (``within_sums_finish``). The sums are exact, so
the result is bitwise reproducible, and bitwise the plain version's. The
16-bit orders come from ``inverse_orders``, which also refuses a tile
holding a row that is not a permutation.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.inverse_orders import (cluster_size,
                                                inverse_orders,
                                                inverse_orders_cost)

#: rows and columns of a tile of the pairs' triangle (``kTile``)
TILE = 128
#: permutations a slab, one a lane (``kLanes``)
LANES = 32
#: permutations a launch (``kMaxPerms``): four slabs, four 64-bit sums a lane
MAX_PERMS = 128
#: bytes an order value and a permuted code take as the kernel reads them
_ORDER_BYTES, _CODE_BYTES = 2, 4


def _tile_sizes(n: int) -> list[int]:
    """Rows (or columns) of each row (or column) tile: TILE, the last
    ragged."""
    return [min(TILE, n - t0) for t0 in range(0, n, TILE)]


def tile_count(n: int) -> int:
    """Tiles of the upper triangle the kernel walks, a <= c."""
    nt = -(-n // TILE)
    return nt * (nt + 1) // 2


def resident_blocks(n: int) -> int:
    """Blocks of a partials launch: what the card holds at once, at most
    the triangle's tiles."""
    return _build.resident_grid("repro_within_sums_grid", n)


def partials_cost(n: int, perms: int, grid: int) -> tuple[float, float]:
    """(bytes, operations) of one ``within_sums_partials`` launch. The m
    fp32 ranks are read once (each pair in the triangle from its tile);
    each tile gathers the permuted codes of its rows and of its columns,
    an order value and a code a (position, permutation). One 64-bit
    partial is stored a (block, permutation). A compare and an add a
    (pair slot of a tile, permutation): the tiles cover the triangle's m
    pairs, and the diagonal tiles' slots at j <= i add an exact 0."""
    m = n * (n - 1) // 2
    sizes = _tile_sizes(n)
    nt = len(sizes)
    # Σ over tiles a <= c of (rows of a + columns of c), and of their product
    edges = sum(s * (nt - a) + s * (a + 1) for a, s in enumerate(sizes))
    slots = sum(sizes[a] * sizes[c] for a in range(nt) for c in range(a, nt))
    loads = 4.0 * m + float(edges) * perms * (_ORDER_BYTES + _CODE_BYTES)
    return loads + 8.0 * grid * perms, 2.0 * slots * perms


def finish_cost(num_chunks: int, perms: int) -> tuple[float, float]:
    """(bytes, operations) of one ``within_sums_finish`` launch: every
    64-bit partial read once, one fp32 sum stored a permutation."""
    return 8.0 * num_chunks * perms + 4.0 * perms, float(num_chunks * perms)


def tile_cost(n: int, perms: int, grid: int) -> tuple[float, float]:
    """(bytes, operations) the launches of one :func:`within_sums_kernel`
    call declare: the tile's ``inverse_orders``, and for each slab of at
    most MAX_PERMS permutations a partials launch on ``grid`` blocks and
    its finish."""
    nbytes, ops = inverse_orders_cost(perms, n, cluster_size(perms, n))
    for b0 in range(0, perms, MAX_PERMS):
        p = min(MAX_PERMS, perms - b0)
        for cost in (partials_cost(n, p, grid), finish_cost(grid, p)):
            nbytes, ops = nbytes + cost[0], ops + cost[1]
    return nbytes, ops


def within_sums_partials(ranks: torch.Tensor, codes: torch.Tensor,
                         orders16: torch.Tensor) -> torch.Tensor:
    """(blocks, B) int64 partial sums of the doubled within-group ranks,
    one per block of the launch (as many as the card holds at once, at
    most the triangle's tiles).

    ranks: (m,) fp32 half-integers; codes: (n,) int32; orders16: (B, n)
    the 16-bit orders (from ``inverse_orders``), 1 <= B <= MAX_PERMS; all
    contiguous on one CUDA device, 2 <= n <= 46340. Returns without
    synchronising.
    """
    perms, n = orders16.shape
    if not 1 <= perms <= MAX_PERMS:
        raise ValueError(f"one launch takes 1..{MAX_PERMS} permutations, "
                         f"got {perms}")
    grid = resident_blocks(n)
    partials = torch.empty((grid, perms), dtype=torch.int64,
                           device=ranks.device)
    err = _build.library().repro_within_sums_partials(
        ranks.data_ptr(), codes.data_ptr(), orders16.data_ptr(),
        partials.data_ptr(), n, perms, grid,
        _build.stream_handle(ranks.device))
    _build.launches["within_sums"] += 1
    if _build.recorder is not None:
        _build.recorder("within_sums", *partials_cost(n, perms, grid))
    _build.check(err, "within_sums")
    return partials


def within_sums_finish(partials: torch.Tensor) -> torch.Tensor:
    """(B,) fp32: the sums over the block axis of (blocks, B) int64
    partials, halved. Returns without synchronising."""
    num_chunks, perms = partials.shape
    out = torch.empty((perms,), dtype=torch.float32, device=partials.device)
    err = _build.library().repro_within_sums_finish(
        partials.data_ptr(), out.data_ptr(), num_chunks, perms,
        _build.stream_handle(partials.device))
    _build.launches["within_sums_finish"] += 1
    if _build.recorder is not None:
        _build.recorder("within_sums_finish",
                        *finish_cost(num_chunks, perms))
    _build.check(err, "within_sums_finish")
    return out


def within_sums_kernel(ranks: torch.Tensor, codes: torch.Tensor,
                       orders: torch.Tensor) -> torch.Tensor:
    """out[b] = Σ_{i<j} ranks[tri(i, j)]·[codes[o_b[i]] == codes[o_b[j]]]
    on the card, (B,) fp32. Refuses orders that are not permutations (one
    ``inverse_orders`` launch and a sync); B above MAX_PERMS runs in
    slabs, each one launch pair."""
    _, orders16 = inverse_orders(orders)
    return torch.cat([
        within_sums_finish(within_sums_partials(
            ranks, codes, orders16[b0:b0 + MAX_PERMS]))
        for b0 in range(0, orders16.shape[0], MAX_PERMS)])
