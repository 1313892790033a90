"""Plain PyTorch version of the condensed centred-Gram product: each row
strip of D gathered from the condensed vector by closed-form triangle
indexing, then ``−½d²``, a matmul and the rank-1 corrections, one strip of
``block`` rows at a time, so the peak extra memory is one (block, n) strip
and never n². The CPU route of ``CondensedCenteredGramOperator.matvec``.

The index arithmetic is int32, exact only for n <= ``MAX_TRIANGLE_N`` (the
operator refuses larger n)."""

from __future__ import annotations

import torch

from repro_torch.core.distance_matrix import condensed_index
from repro_torch.kernels.center_matvec_ref import center_corrections


def condensed_row_panel(dc: torch.Tensor, n: int, i0: int, b: int
                        ) -> torch.Tensor:
    """Rows [i0, i0+b) of the (n, n) D gathered from the condensed ``dc``."""
    if dc.shape[0] == 0:                   # n <= 1: no off-diagonal pairs
        return torch.zeros((b, n), dtype=dc.dtype, device=dc.device)
    r = torch.arange(i0, i0 + b, dtype=torch.int32,
                     device=dc.device)[:, None]
    c = torch.arange(n, dtype=torch.int32, device=dc.device)[None, :]
    on_diag = r == c
    k = condensed_index(r, c, n)
    return torch.where(on_diag, 0.0, dc[torch.where(on_diag, 0, k).long()])


def condensed_matvec_ref(dc: torch.Tensor, x: torch.Tensor,
                         row_means: torch.Tensor, global_mean: torch.Tensor,
                         n: int, block: int = 256) -> torch.Tensor:
    """``F @ x`` for the Gower-centred F of the condensed ``dc``, given the
    row means and global mean of ``E = −½ D∘D``, one (block, n) strip of D
    at a time."""
    colsum, corr = center_corrections(x, row_means, global_mean)
    b = max(min(block, n), 1)
    out = torch.empty((n, x.shape[1]), dtype=x.dtype, device=x.device)
    for i0 in range(0, n, b):
        bi = min(b, n - i0)
        rows = condensed_row_panel(dc, n, i0, bi)
        e_rows = -0.5 * rows * rows
        out[i0:i0 + bi] = (e_rows @ x - row_means[i0:i0 + bi, None]
                           * colsum[None, :] + corr[None, :])
    return out
