"""Plain PyTorch versions of the centering kernels.

* ``center_distance_matrix_ref`` — the counterpart of
  ``repro/kernels/center_ref.py``: Gower double-centering as Algorithm 1
  writes it, one eager op at a time, in the input's dtype.
* ``center_pass1_ref``, ``center_finish_ref``, ``center_pass2_ref`` — the
  plain version of each of the three kernels of ``csrc/center.cu``, with
  its arithmetic: E in fp32 whatever the input dtype, the global sum in
  fp64, F rounded to the input dtype at the end. ``center_two_pass_ref``
  chains them; it is what the kernels' wrapper runs on a CPU tensor.
  Passes 1 and 2 take an (r, c) block of D as the kernels' block mode
  does (pass 2 with its column means apart).
"""

from __future__ import annotations

from typing import Optional

import torch


def center_distance_matrix_ref(d: torch.Tensor) -> torch.Tensor:
    """Gower double-centering: F = E − rowmean − colmean + mean, E = −D²/2."""
    e = d * d / -2.0
    row_means = e.mean(dim=1, keepdim=True)
    col_means = e.mean(dim=0, keepdim=True)
    matrix_mean = e.mean()
    return e - row_means - col_means + matrix_mean


def _e(d: torch.Tensor) -> torch.Tensor:
    d = d.float()
    return -0.5 * d * d


def center_pass1_ref(d: torch.Tensor) -> torch.Tensor:
    """(r,) fp32 row sums of E = −½ d∘d for an (r, c) ``d``."""
    return torch.sum(_e(d), dim=1)


def center_finish_ref(row_sums: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(row means (n,), global mean (1,)) of E from its fp32 row sums."""
    n = row_sums.shape[0]
    global_mean = torch.sum(row_sums.double()) / n / n
    return row_sums / n, global_mean.float().reshape(1)


def center_pass2_ref(d: torch.Tensor, row_means: torch.Tensor,
                     global_mean: torch.Tensor,
                     col_means: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """F = E − r_i − c_j + m for an (r, c) ``d``, rounded to its dtype;
    ``col_means=None`` takes the row means (the square matrix)."""
    col_means = row_means if col_means is None else col_means
    f = _e(d) - row_means[:, None] - col_means[None, :] + global_mean
    return f.to(d.dtype)


def center_two_pass_ref(d: torch.Tensor) -> torch.Tensor:
    """The kernel pair's plain version: pass 1, the finish, pass 2."""
    row_means, global_mean = center_finish_ref(center_pass1_ref(d))
    return center_pass2_ref(d, row_means, global_mean)
