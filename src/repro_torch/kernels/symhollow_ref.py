"""Plain PyTorch version of the fused validation kernel: the function of the
reference's fused pass (``repro/core/validation.py:55-61``), which the CPU
path runs and the card's kernel is held against."""

from __future__ import annotations

import torch


def is_symmetric_and_hollow_ref(mat: torch.Tensor) -> tuple[bool, bool]:
    """``(all(mat == mat.T), all(diag(mat) == 0))``. NaN compares unequal,
    so any NaN makes the matrix asymmetric; -0.0 on the diagonal is
    hollow."""
    is_sym = bool(torch.all(mat == mat.T))
    is_hollow = bool(torch.all(torch.diagonal(mat) == 0))
    return is_sym, is_hollow
