"""PCoA matrix centering: paper §4.1, Algorithms 1 & 2.

The counterpart of ``repro/core/centering.py``. Gower double-centering:
``F = E − rowmean(E) − colmean(E) + mean(E)`` with ``E = −½ D∘D``. In the
port these serve only the materialized paths (the eigh oracle and
materialized fsvd); the matrix-free path never forms F.

* ``center_distance_matrix_ref`` — Algorithm 1: eager, one op at a time.
* ``center_distance_matrix`` — Algorithm 2, two passes: on a CUDA tensor
  the hand-written ``center`` kernel pair (pass 1 row sums, a fixed-order
  finish, pass 2), on a CPU tensor its plain version.
* ``center_distance_matrix_blocked`` — Algorithm 2's two loops with
  explicit row-block tiling, in plain PyTorch: the structural reference
  for the kernels' tiling.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.center_ops import center_distance_matrix_op


def center_distance_matrix_ref(distance_matrix: torch.Tensor) -> torch.Tensor:
    """Algorithm 1: eager multi-pass centering, one op at a time."""
    e = distance_matrix * distance_matrix / -2
    row_means = e.mean(dim=1, keepdim=True)
    col_means = e.mean(dim=0, keepdim=True)
    return e - row_means - col_means + e.mean()


def center_distance_matrix(distance_matrix: torch.Tensor) -> torch.Tensor:
    """Algorithm 2: E's row sums and global sum in one sweep, then the
    centering; symmetry makes the row means the column means."""
    return center_distance_matrix_op(distance_matrix.contiguous())


def center_distance_matrix_blocked(distance_matrix: torch.Tensor,
                                   block: int = 1024) -> torch.Tensor:
    """Algorithm 2's two loops over row blocks. A ragged n is zero-padded
    to whole blocks: padded entries add 0 to E (−½·0² = 0), the means
    divide by the true n, and the padding is sliced off at the end."""
    n = distance_matrix.shape[0]
    # a small n is not padded to a full default-sized block
    block = min(block, ((n + 7) // 8) * 8)
    pad = (-n) % block
    d = torch.nn.functional.pad(distance_matrix, (0, pad, 0, pad)) \
        if pad else distance_matrix
    n_padded = n + pad

    e_blocks, row_sums = [], []            # pass 1: E and its row sums
    for i0 in range(0, n_padded, block):
        rows = d[i0:i0 + block]
        e_rows = -0.5 * rows * rows
        e_blocks.append(e_rows)
        row_sums.append(torch.sum(e_rows, dim=1))
    row_sums = torch.cat(row_sums)
    row_means = row_sums / n
    global_mean = torch.sum(row_sums) / (n * n)

    out = torch.cat([                      # pass 2: the centering
        e_rows + (global_mean - row_means[i0:i0 + block])[:, None]
        - row_means[None, :]
        for i0, e_rows in zip(range(0, n_padded, block), e_blocks)])
    return out[:n, :n] if pad else out
