"""Plain PyTorch versions of the batched permuted gather-reduce.

* ``permute_reduce_ref`` — the closed-form triangle gather, one condensed
  chunk at a time (peak extra memory one (B, chunk) gather tile, as the
  reference's ``_reduce_xla``), with the products accumulated in fp64. The
  CPU path runs it; the card's kernel is held against it.
* ``permute_reduce_rows`` — the same function by the card kernel's walk:
  the inverse orders, then row by row of x, each row of the square staged
  from the condensed run and column, the run of ys row ``inv[b, r]``
  against ``x_row[orders[b, j]]`` for j past it. It shows the
  reformulation equals the reference's function.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.inverse_orders import (inverse_orders_plain,
                                                require_permutations)


def permute_reduce_ref(xc: torch.Tensor, ys: torch.Tensor, ii: torch.Tensor,
                       jj: torch.Tensor, orders: torch.Tensor, n: int,
                       chunk: int) -> torch.Tensor:
    """out[s, b] = Σ_k ys[s, k]·xc[tri(orders[b, ii[k]], orders[b, jj[k]])].

    ys (S, L), ii/jj (L,) with L = m or a padded length whose padded
    entries carry zero ``ys``; orders (B, n) int32. Returns (S, B) in
    ``xc``'s dtype.
    """
    rows, length = ys.shape
    acc = torch.zeros((rows, orders.shape[0]), dtype=torch.float64,
                      device=xc.device)
    for c0 in range(0, length, chunk):
        oi = orders[:, ii[c0:c0 + chunk].long()]          # (B, chunk) int32
        oj = orders[:, jj[c0:c0 + chunk].long()]
        lo = torch.minimum(oi, oj)
        hi = torch.maximum(oi, oj)
        k = lo * (2 * n - lo - 1) // 2 + (hi - lo - 1)     # int32-exact, n <= 46340
        xg = xc[k.long()].double()
        acc += ys[:, c0:c0 + chunk].double() @ xg.T
    return acc.to(xc.dtype)


def permute_reduce_finish_ref(partials: torch.Tensor) -> torch.Tensor:
    """The (S, B) fp32 sums over the chunk axis of (chunks, S, B) fp64
    partials: the plain version of the fixed-order finishing kernel."""
    return partials.sum(dim=0).to(torch.float32)


def permute_reduce_rows(xc: torch.Tensor, ys: torch.Tensor,
                        orders: torch.Tensor) -> torch.Tensor:
    """out[s, b] = Σ_r Σ_{j > π_b(r)} ys[s, tri(π_b(r), j)]·x[r, o_b[j]],
    π_b the inverse of o_b: the row-stationary kernel's loop, one row of x
    at a time, in fp64. ys (S, m); orders (B, n) permutations (refused
    otherwise). Returns (S, B) in ``xc``'s dtype."""
    perms, n = orders.shape
    inv, _, is_perm = inverse_orders_plain(orders)
    require_permutations(is_perm, n)
    inv, o = inv.long(), orders.long()
    idx = torch.arange(n, device=xc.device)
    starts = idx * (2 * n - idx - 1) // 2            # tri(q, q + 1)
    out = torch.zeros((ys.shape[0], perms), dtype=torch.float64,
                      device=xc.device)
    for r in range(n):
        x_row = torch.zeros((n,), dtype=torch.float64, device=xc.device)
        x_row[r + 1:] = xc[starts[r]:starts[r] + n - 1 - r]      # the run
        x_row[:r] = xc[starts[:r] + r - idx[:r] - 1]             # the column
        i = inv[:, r]                                            # (B,)
        past = idx[None, :] > i[:, None]                         # j > π_b(r)
        k = torch.where(past, (starts[i] - i - 1)[:, None] + idx[None, :], 0)
        terms = ys[:, k].double() * x_row[o][None]               # (S, B, n)
        out += torch.where(past[None], terms, 0.0).sum(dim=-1)
    return out.to(xc.dtype)
