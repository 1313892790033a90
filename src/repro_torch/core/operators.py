"""The matrix-free centred-Gram operator: the §4.1 traffic argument.

The counterpart of ``repro/core/operators.py::CenteredGramOperator``. The
randomized eigensolver consumes the Gower-centred
``F = E − r·1ᵀ − 1·rᵀ + m`` (``E = −½ D∘D``) only through products with
skinny (n, k) blocks, and

    F @ X = E @ X − r (1ᵀX) − 1 (rᵀX) + m·1 (1ᵀX)

so ``r`` and ``m`` are hoisted once and F is never formed. On the card
``matvec`` always goes through the ``center_matvec`` kernel; on the CPU
through its plain version.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.centering import center_distance_matrix
from repro_torch.kernels.center_matvec_ops import center_matvec_op


@dataclasses.dataclass
class CenteredGramOperator:
    """The Gower-centred Gram matrix of a distance matrix, as an operator."""

    d: torch.Tensor            # (n, n) distance matrix — the only n² buffer
    row_means: torch.Tensor    # (n,)  row means of E = −½ D∘D (== col means)
    global_mean: torch.Tensor  # ()    global mean of E
    n: int

    @classmethod
    def from_distance(cls, d: torch.Tensor) -> "CenteredGramOperator":
        """Hoist r and m from D."""
        row_means = -0.5 * torch.mean(d * d, dim=1)
        return cls(d, row_means, torch.mean(row_means), d.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.d.dtype

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``F @ x`` without forming F. ``x``: (n, k), or (n,) which is
        promoted and squeezed back."""
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        out = center_matvec_op(self.d, x.contiguous(), self.row_means,
                               self.global_mean)
        return out[:, 0] if squeeze else out

    def trace(self) -> torch.Tensor:
        """Exact ``tr(F) = tr(E) − n·m`` from the hoisted sums (``tr(E) =
        0`` for a hollow D, so the total inertia is ``−n·m``)."""
        tr_e = -0.5 * torch.sum(torch.diagonal(self.d) ** 2)
        return tr_e - self.n * self.global_mean

    def materialize(self) -> torch.Tensor:
        """The full F — the oracle path (``method="eigh"`` needs it)."""
        return center_distance_matrix(self.d)
