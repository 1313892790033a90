"""The matrix-free centred-Gram operator: the §4.1 traffic argument.

The counterpart of ``repro/core/operators.py::CenteredGramOperator``. The
randomized eigensolver consumes the Gower-centred
``F = E − r·1ᵀ − 1·rᵀ + m`` (``E = −½ D∘D``) only through products with
skinny (n, k) blocks, and

    F @ X = E @ X − r (1ᵀX) − 1 (rᵀX) + m·1 (1ᵀX)

so ``r`` and ``m`` are hoisted once and F is never formed. On the card
``CenteredGramOperator.matvec`` always goes through the ``center_matvec``
kernel; on the CPU through its plain version. Each product of either
operator runs in an ``operator.matvec`` span.

``CondensedCenteredGramOperator`` is the same operator backed by the
condensed distances of a feature-table production
(``repro_torch.dist.pairwise_condensed``), whose means it takes for free.
On the card each of its products is one launch of the
``condensed_matvec`` kernel, which reads D straight from the condensed
vector (the reference has no kernel there: it gathers each row strip with
jnp ops); on the CPU the kernel's plain version gathers a row strip of
``block`` rows at a time and multiplies with ``torch.matmul``.

``centered_gram_matvec_distributed`` is ``F @ X`` over a D block-sharded on
a device mesh, as ``core.centering``'s distributed centering lays it out:
each rank's product is the ``center_matvec`` kernel on its block, and
only O(n·k) bytes cross the interconnect.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.centering import center_distance_matrix
from repro_torch.core.distance_matrix import (MAX_TRIANGLE_N,
                                              condensed_to_square)
from repro_torch.kernels.center_matvec_ops import (block_product_op,
                                                   center_matvec_op)
from repro_torch.kernels.center_ops import center_row_sums_op
from repro_torch.kernels.condensed_matvec_ops import condensed_matvec_op
from repro_torch.kernels.condensed_matvec_ref import condensed_row_panel
from repro_torch.kernels.dispatch import require
from repro_torch.launch.mesh import (check_device, full_tensor, local_block,
                                     placements, psum)
from repro_torch.obs.trace import current_obs


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
        with current_obs().span("operator.matvec", n=self.n, k=x.shape[1]):
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


@dataclasses.dataclass
class CondensedCenteredGramOperator:
    """The centred-Gram operator backed by the CONDENSED distances.

    The m = n(n−1)/2 condensed vector is the only large buffer, and D is
    read from it by closed-form triangle indexing,

        k(i, j) = i(2n − i − 1)/2 + (j − i − 1)   for i < j  (scipy layout),

    so no n×n position map is built either: by the ``condensed_matvec``
    kernel on the card, a row strip of ``block`` rows at a time on the CPU.
    The index arithmetic is int32, exact only for n <= 46340 (an overflow
    would read silently wrong distances), so construction refuses larger
    n. D is hollow by construction, so ``trace`` needs no diagonal term.
    """

    dc: torch.Tensor           # (m,) condensed distances — the only big buffer
    row_means: torch.Tensor    # (n,)  row means of E = −½ D∘D
    global_mean: torch.Tensor  # ()    global mean of E
    n: int
    block: int = 256

    def __post_init__(self):
        if self.n > MAX_TRIANGLE_N:
            raise ValueError(
                f"CondensedCenteredGramOperator supports n <= "
                f"{MAX_TRIANGLE_N} (int32 triangle indexing would overflow "
                f"and silently corrupt the gather); got n={self.n}")

    @classmethod
    def from_production(cls, prod: dict, *, block: int = 256
                        ) -> "CondensedCenteredGramOperator":
        """Wrap a ``repro_torch.dist.pairwise_condensed`` result: its means
        were accumulated during the production, so this costs nothing."""
        return cls(prod["condensed"], prod["row_means"], prod["global_mean"],
                   prod["n"], block)

    @property
    def dtype(self) -> torch.dtype:
        return self.dc.dtype

    @property
    def device(self) -> torch.device:
        return self.dc.device

    def row_panel(self, i0: int, b: int) -> torch.Tensor:
        """Rows [i0, i0+b) of D gathered from the condensed vector."""
        return condensed_row_panel(self.dc, self.n, i0, b)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``F @ x`` with D read from the condensed storage: one
        ``condensed_matvec`` launch (a slab of 128 columns) on the card, a
        (block, n) strip at a time on the CPU; never n² extra memory."""
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        with current_obs().span("operator.matvec", n=self.n, k=x.shape[1]):
            out = condensed_matvec_op(self.dc, x.contiguous(), self.row_means,
                                      self.global_mean, self.n,
                                      block=self.block)
        return out[:, 0] if squeeze else out

    def trace(self) -> torch.Tensor:
        """Exact ``tr(F) = Σλ``: the condensed form is hollow, so
        tr(E) = 0 and tr(F) = −n·m̄."""
        return -self.n * self.global_mean

    def to_square(self) -> torch.Tensor:
        """The full symmetric hollow D — only for callers that ask for a
        square; it defeats the point otherwise."""
        return condensed_to_square(self.dc, self.n)

    def materialize(self) -> torch.Tensor:
        """The full Gower-centred F (the eigh oracle path): the ``center``
        kernel pair on the card."""
        return center_distance_matrix(self.to_square())


def centered_gram_matvec_distributed(d, x: torch.Tensor, mesh,
                                     row_axis: str = "data",
                                     col_axis: str = "model") -> DTensor:
    """``F @ x`` over a block-sharded D, no n² tensor anywhere.

    The mesh layout of ``center_distance_matrix_distributed``: ``d`` is a
    plain (n, n) tensor every rank holds or a DTensor placed ``Shard(0)``
    on ``row_axis`` and ``Shard(1)`` on ``col_axis``; ``x`` is the (n, k)
    fp32 block every rank holds (a DTensor is assembled first). Each rank
    contracts its block against its column slice of x with the
    ``center_matvec`` kernel (no E block is formed), and a psum over
    ``col_axis`` assembles the row strip of E@X. The corrections need
    O(n)+O(k) collectives, as in the reference: the row sums over the
    column axis, the global sum over both, 1ᵀX and rᵀX over the row axis.
    The means are recomputed each call (each rank's pass over its block),
    which keeps the call self-contained. Returns an (n, k) DTensor sharded
    on rows over ``row_axis``.
    """
    block, i0, j0, n = local_block(d, mesh, row_axis, col_axis)
    rows, cols = block.shape
    x = full_tensor(x).contiguous()
    if x.ndim != 2 or x.shape[0] != n:
        raise ValueError(f"x must be ({n}, k), got {tuple(x.shape)}")
    require(x, "x", torch.float32)
    check_device(mesh, x)
    x_row, x_col = x[i0:i0 + rows], x[j0:j0 + cols].contiguous()
    part = psum(block_product_op(block, x_col), mesh, col_axis)
    local_row_sums = center_row_sums_op(block)
    row_means = psum(local_row_sums, mesh, col_axis) / n
    global_mean = (psum(local_row_sums.double().sum(), mesh,
                        (row_axis, col_axis)) / n / n).float()
    colsum = psum(x_row.sum(dim=0), mesh, row_axis)
    rmx = psum(row_means @ x_row, mesh, row_axis)
    out = part - row_means[:, None] * colsum[None, :] \
        + (global_mean * colsum - rmx)[None, :]
    k = x.shape[1]
    return DTensor.from_local(out, mesh, placements(mesh, {row_axis: 0}),
                              run_check=False, shape=(n, k), stride=(k, 1))
