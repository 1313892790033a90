"""Plain PyTorch version of the batched permuted gather-reduce.

The same closed-form triangle gather as the kernel, one condensed chunk at
a time (peak extra memory one (B, chunk) gather tile, as the reference's
``_reduce_xla``), with the products accumulated in fp64 like the kernel's.
The CPU path runs it; the card's kernel is held against it.
"""

from __future__ import annotations

import torch


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
