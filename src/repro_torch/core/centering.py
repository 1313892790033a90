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
* ``center_distance_matrix_distributed`` — the same two passes over a
  matrix block-sharded on a device mesh: each rank reads its block twice
  and only O(n) row sums cross the interconnect.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.center_ops import (center_block_op,
                                            center_distance_matrix_op,
                                            center_means_op,
                                            center_row_sums_op)
from repro_torch.launch.mesh import (all_gather_tiled, local_block,
                                     placements, psum)


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


def center_distance_matrix_distributed(distance_matrix, mesh,
                                       row_axis: str = "data",
                                       col_axis: str = "model") -> DTensor:
    """Gower centering of an (n, n) matrix block-sharded over ``mesh``:
    rows over ``row_axis``, columns over ``col_axis``.

    ``distance_matrix`` is a plain tensor every rank holds, or a DTensor
    placed ``Shard(0)`` on ``row_axis`` and ``Shard(1)`` on ``col_axis``;
    n must divide over both. Each rank runs pass 1 on its (n/Pr, n/Pc)
    block; its rows' sums are completed by a psum over ``col_axis``, and an
    all_gather over ``row_axis`` gives every rank all n row sums (O(n)
    bytes). The fixed-order finish then gives every rank the same row means
    and global mean, bit for bit, and pass 2 writes the block of F from its
    rows' and its columns' means (D symmetric: the column means are the row
    means). Returns a DTensor with the input's placements; on a 1 x 1 mesh
    its block is exactly what ``center_distance_matrix`` computes.
    """
    block, i0, j0, n = local_block(distance_matrix, mesh, row_axis, col_axis)
    rows, cols = block.shape
    row_sums = psum(center_row_sums_op(block), mesh, col_axis)
    row_means, global_mean = center_means_op(
        all_gather_tiled(row_sums, mesh, row_axis))
    f = center_block_op(block, row_means[i0:i0 + rows].contiguous(),
                        row_means[j0:j0 + cols].contiguous(), global_mean)
    return DTensor.from_local(f, mesh,
                              placements(mesh, {row_axis: 0, col_axis: 1}),
                              run_check=False, shape=(n, n), stride=(n, 1))
