"""Plain PyTorch versions of the batched permuted-Pearson reduction.

* ``mantel_corr_ref`` — the oracle of ``repro/kernels/mantel_corr_ref.py``:
  per permutation, Pearson r computed the original way (scipy ``pearsonr``
  semantics, paper Algorithms 3 + 4).
* ``mantel_corr_plain`` — the kernel's own function,
  ``stats[b] = Σ_ij x[o_b[i], o_b[j]]·ŷ[i, j]``, gathered a row block at a
  time (peak extra memory one (ROW_CHUNK, n) block) and summed in fp64. The
  CPU path runs it; the card's kernel is held against it.
* ``mantel_corr_rows`` — the same function by the card kernel's walk: the
  inverse orders, then row by row of x, ŷ row ``inv[b, r]`` against
  ``x_row[orders[b, j]]``. It shows the reformulation equals the
  reference's function.

Both take the kernel's column-range mode: ŷ the (n, c) columns [c0, c0 + c)
of the square, the sum over those columns only (the square: c0 = 0).
"""

from __future__ import annotations

import torch

from repro_torch.core.distance_matrix import condensed_form
from repro_torch.kernels.inverse_orders import (inverse_orders_plain,
                                                require_permutations)

#: rows of the permuted square gathered at once by ``mantel_corr_plain``.
ROW_CHUNK = 1024


def mantel_corr_ref(x: torch.Tensor, y_flat: torch.Tensor,
                    orders: torch.Tensor) -> torch.Tensor:
    """r[p] = pearsonr(condensed(x[o_p][:, o_p]), y_flat), (K,).

    ``y_flat`` is the raw condensed y: mean and norm are re-derived from
    scratch, as the original implementation does."""
    ym = y_flat - y_flat.mean()
    ynorm = ym / torch.linalg.vector_norm(ym)
    out = []
    for order in orders.long():
        xf = condensed_form(x[order][:, order])
        xm = xf - xf.mean()
        out.append(torch.dot(xm / torch.linalg.vector_norm(xm), ynorm))
    return torch.stack(out) if out else \
        torch.zeros((0,), dtype=x.dtype, device=x.device)


def mantel_corr_plain(x: torch.Tensor, yhat: torch.Tensor,
                      orders: torch.Tensor, c0: int = 0) -> torch.Tensor:
    """stats[b] = Σ_i Σ_{j∈[c0, c0+c)} x[o_b[i], o_b[j]]·ŷ[i, j − c0], (B,)
    in ``x``'s dtype.

    x: (n, n); yhat: (n, c); orders: (B, n) integer permutations."""
    n, cols = yhat.shape
    out = torch.zeros((orders.shape[0],), dtype=torch.float64,
                      device=x.device)
    for b, order in enumerate(orders.long()):
        for r0 in range(0, n, ROW_CHUNK):
            rows = x[order[r0:r0 + ROW_CHUNK]][:, order[c0:c0 + cols]]
            out[b] += torch.sum(rows.double() * yhat[r0:r0 + ROW_CHUNK].double())
    return out.to(x.dtype)


def mantel_corr_rows(x: torch.Tensor, yhat: torch.Tensor,
                     orders: torch.Tensor, c0: int = 0) -> torch.Tensor:
    """stats[b] = Σ_r Σ_{j∈[c0, c0+c)} x[r, o_b[j]]·ŷ[π_b(r), j − c0], π_b
    the inverse of o_b: the row-stationary kernel's loop, one row of x at
    a time, in fp64. orders (B, n) permutations (refused otherwise).
    Returns (B,) in ``x``'s dtype."""
    n, cols = yhat.shape
    inv, _, is_perm = inverse_orders_plain(orders)
    require_permutations(is_perm, n)
    inv, o = inv.long(), orders.long()[:, c0:c0 + cols]
    out = torch.zeros((orders.shape[0],), dtype=torch.float64,
                      device=x.device)
    for r in range(n):
        out += torch.sum(yhat[inv[:, r]].double() * x[r][o].double(), dim=1)
    return out.to(x.dtype)
