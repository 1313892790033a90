"""PCoA matrix centering: paper §4.1, Algorithms 1 & 2, as plain PyTorch.

The counterpart of ``repro/core/centering.py``. Gower double-centering:
``F = E − rowmean(E) − colmean(E) + mean(E)`` with ``E = −½ D∘D``. In the
port these serve only the materialized paths (the eigh oracle and
materialized fsvd); the matrix-free path never forms F. The ``center``
kernel pair of the reference is not ported yet.
"""

from __future__ import annotations

import torch


def center_distance_matrix_ref(distance_matrix: torch.Tensor) -> torch.Tensor:
    """Algorithm 1: eager multi-pass centering, one op at a time."""
    e = distance_matrix * distance_matrix / -2
    row_means = e.mean(dim=1, keepdim=True)
    col_means = e.mean(dim=0, keepdim=True)
    return e - row_means - col_means + e.mean()


def center_distance_matrix(distance_matrix: torch.Tensor) -> torch.Tensor:
    """Algorithm 2: E with its row sums and global sum, then the centering;
    symmetry makes the row means the column means."""
    e = -0.5 * distance_matrix * distance_matrix
    row_means = torch.mean(e, dim=1)
    global_mean = torch.mean(row_means)
    return e - row_means[:, None] - row_means[None, :] + global_mean
