"""Plain PyTorch versions of the within-group rank sums.

* ``within_sums_ref`` — the closed-form triangle walk, one condensed chunk
  at a time (peak extra memory a few (B, chunk) tiles): each pair's
  permuted codes compared, the matching pairs' doubled ranks summed in
  int64, the total halved to fp32 as the card's finish halves it. The CPU
  path and ANOSIM's observed statistic run it; the card's kernel is held
  against it, bit for bit.
* ``within_sums_tiles`` — the same function by the card kernel's walk: the
  triangle cut into TILE x TILE tiles (row tile a <= column tile c), each
  tile's ranks and its rows' and columns' permuted codes staged, the
  diagonal tiles masked to j > i. It shows the tiling counts every pair
  once.
"""

from __future__ import annotations

import torch

from repro_torch.core.distance_matrix import triangle_coords


def doubled(ranks: torch.Tensor) -> torch.Tensor:
    """2·rank as int64, rounded half to even as the kernel's
    ``__float2uint_rn`` rounds it: exact for half-integer ranks."""
    return torch.round(2.0 * ranks).to(torch.int64)


def halved(totals: torch.Tensor) -> torch.Tensor:
    """fp32 halves of int64 sums of doubled ranks: to fp64, times 0.5,
    to fp32, as the finishing kernel rounds them."""
    return (totals.to(torch.float64) * 0.5).to(torch.float32)


def within_sums_ref(ranks: torch.Tensor, codes: torch.Tensor,
                    orders: torch.Tensor, chunk: int) -> torch.Tensor:
    """out[b] = Σ_{i<j} ranks[tri(i, j)]·[codes[o_b[i]] == codes[o_b[j]]].

    ranks (m,) half-integers; codes (n,) integer; orders (B, n) integer
    indices into codes. Returns (B,) fp32.
    """
    n = codes.numel()
    m = n * (n - 1) // 2
    permuted = codes.long()[orders.long()]                   # (B, n)
    totals = torch.zeros((orders.shape[0],), dtype=torch.int64,
                         device=ranks.device)
    for k0 in range(0, m, chunk):
        k1 = min(k0 + chunk, m)
        ii, jj = triangle_coords(n, ranks.device, k0, k1)
        same = permuted[:, ii.long()] == permuted[:, jj.long()]
        totals += torch.where(same, doubled(ranks[k0:k1]), 0).sum(dim=1)
    return halved(totals)


def within_sums_finish_ref(partials: torch.Tensor) -> torch.Tensor:
    """The (B,) fp32 halves of the sums over the block axis of (blocks, B)
    int64 partials: the plain version of the finishing kernel."""
    return halved(partials.sum(dim=0))


def within_sums_tiles(ranks: torch.Tensor, codes: torch.Tensor,
                      orders: torch.Tensor, tile: int) -> torch.Tensor:
    """The function of :func:`within_sums_ref` by the kernel's walk over
    ``tile`` x ``tile`` tiles of the triangle. Returns (B,) fp32."""
    n = codes.numel()
    permuted = codes.long()[orders.long()]                   # (B, n)
    idx = torch.arange(n, device=ranks.device)
    totals = torch.zeros((orders.shape[0],), dtype=torch.int64,
                         device=ranks.device)
    for i0 in range(0, n, tile):
        i = idx[i0:i0 + tile]
        base = i * (2 * n - i - 1) // 2 - i - 1              # tri(i, j) = base + j
        for j0 in range(i0, n, tile):
            j = idx[j0:j0 + tile]
            live = j[None, :] > i[:, None]                   # the triangle
            k = torch.where(live, base[:, None] + j[None, :], 0)
            staged = torch.where(live, doubled(ranks[k]), 0)   # (rows, cols)
            same = permuted[:, i0:i0 + tile, None] == \
                permuted[:, None, j0:j0 + tile]              # (B, rows, cols)
            totals += torch.where(same, staged[None], 0).sum(dim=(1, 2))
    return halved(totals)
