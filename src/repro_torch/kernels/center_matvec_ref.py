"""Plain PyTorch version of the fused center-matvec kernel: form E in full,
multiply, then apply the same rank-1 corrections — the n² intermediate the
kernel exists to avoid. The product is summed in fp64 and rounded to fp32,
so that held against it the kernel shows its own rounding error.

``center_matvec_block_ref`` is the kernel's function on an (r, c) block of
D with given corrections (its block mode); ``center_matvec_ref`` is the
square call, the corrections hoisted from the means."""

from __future__ import annotations

import torch


def center_corrections(x: torch.Tensor, row_means: torch.Tensor,
                       global_mean: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The O(k) vectors ``colsum = 1ᵀX`` and ``corr = m·1ᵀX − rᵀX``, taken
    on the unpadded operands."""
    colsum = x.sum(dim=0)
    corr = global_mean * colsum - row_means @ x
    return colsum, corr


def center_matvec_block_ref(d: torch.Tensor, x: torch.Tensor,
                            row_means: torch.Tensor, colsum: torch.Tensor,
                            corr: torch.Tensor) -> torch.Tensor:
    """(r, k) ``E@X − r·colsumᵀ + corrᵀ`` for an (r, c) ``d`` and (c, k)
    ``x``, ``E = −½ d∘d``."""
    e = -0.5 * d * d
    ex = (e.double() @ x.double()).to(x.dtype)
    return ex + (corr[None, :] - row_means[:, None] * colsum[None, :])


def center_matvec_ref(d: torch.Tensor, x: torch.Tensor,
                      row_means: torch.Tensor,
                      global_mean: torch.Tensor) -> torch.Tensor:
    """``F @ x`` for the Gower-centred F of ``d``, given the row means and
    global mean of ``E = −½ d∘d``."""
    colsum, corr = center_corrections(x, row_means, global_mean)
    return center_matvec_block_ref(d, x, row_means, colsum, corr)
