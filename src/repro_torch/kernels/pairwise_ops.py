"""Public wrapper for the pairwise-panel kernels.

The counterpart of ``repro/kernels/pairwise_ops.py``. It checks the
operands and dispatches: the CUDA kernel on a CUDA tensor, the plain
chunked panel (``pairwise_ref.pairwise_panel_ref``) on a CPU tensor. The
kernel masks ragged rows and features itself, so nothing is padded (the
reference pads the column blocks and the feature axis here).

The sparse-support route. Given the compressed copy of the table
(:class:`RowSupport`, made by :func:`row_support`) as the metric
(:class:`SparseBrayCurtis`), a Bray–Curtis panel is summed over each
table row's nonzeros instead of over all features: for any signs the
zeros of b add nothing to

    Σ_f |a_f − b_f| = Σ_{f ∈ supp b} (|a_f − b_f| − |a_f|) + Σ_f |a_f|,

and likewise for Σ_f |a_f + b_f|. On the card that is the
``pairwise_sparse_panel`` kernel (``csrc/pairwise_sparse.cu``), on the CPU
its plain version (``pairwise_ref.pairwise_sparse_panel_ref``). The panel
is then a run of the table's own rows, a view ``x[row0 : row0 + bm]``, and
its diagonal is exactly 0. Which productions take the route is
``dist/driver.py``'s rule: the condensed Bray–Curtis production of a
table mostly zeros, which makes the compressed copy before its panel loop
and drops it before it returns. ``pairwise_distances(out="square")`` keeps
the dense kernel, whose d(i, j) and d(j, i) are one expression: the sum
over supp b is not, and the square's exact symmetry needs it.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple

import torch

from repro_torch.dist.metrics import Metric, get_metric
from repro_torch.kernels.dispatch import require, same_device
from repro_torch.kernels.pairwise import pairwise_panel, pairwise_sparse_panel
from repro_torch.kernels.pairwise_ref import (pairwise_panel_ref,
                                              pairwise_sparse_panel_ref)
from repro_torch.obs.compile import note_trace

class RowSupport(NamedTuple):
    """The compressed copy of an (n, d) fp32 table: each row's nonzeros,
    features ascending within a row."""

    offsets: torch.Tensor   # (n + 1,) int32: where each row's nonzeros start
    indices: torch.Tensor   # (nnz,) int32: the feature of each nonzero
    values: torch.Tensor    # (nnz,) fp32
    d: int
    max_row: int            # the most nonzeros one row holds

    @property
    def n(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]


@dataclasses.dataclass(frozen=True)
class SparseBrayCurtis:
    """The metric of the sparse-support route: Bray–Curtis, summed over the
    nonzeros of ``support``, the compressed copy of the table ``x`` the
    panel is taken against."""

    support: RowSupport
    name: ClassVar[str] = "braycurtis"


def row_nonzeros(x: torch.Tensor) -> torch.Tensor:
    """(n,) int64: the nonzeros of each row of ``x``, its ℓ0 norm, in one
    reduction over the table with no temporary of its size (exact in fp32
    for fewer than 2**24 features)."""
    return torch.linalg.vector_norm(x, ord=0, dim=1).to(torch.int64)


def row_support(x: torch.Tensor, counts: torch.Tensor,
                max_row: int) -> RowSupport:
    """The compressed copy of the contiguous fp32 table ``x`` (fewer than
    2**31 elements and 2**24 features), on its device, from its rows'
    nonzero counts (:func:`row_nonzeros`) and their largest. One selection
    over the table in row-major order gives each nonzero's flat position;
    no dense copy is made."""
    n, d = x.shape
    flat = torch.flatten(x).nonzero().squeeze(1)
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=x.device)
    offsets[1:] = torch.cumsum(counts, 0)
    values = torch.flatten(x)[flat]
    indices = flat.remainder_(d).to(torch.int32)
    return RowSupport(offsets, indices, values, d, max_row)


def pairwise_panel_op(xi: torch.Tensor, x: torch.Tensor,
                      metric: Metric | SparseBrayCurtis | str = "braycurtis"
                      ) -> torch.Tensor:
    """One distance row panel: (bm, d) × (n, d) → (bm, n), the metric's
    elementwise reduce fused over the features.

    With a :class:`SparseBrayCurtis` metric, the panel is Bray–Curtis
    summed over each row's nonzeros, and ``xi`` must be a view of rows of
    ``x``, ``x[row0 : row0 + bm]``."""
    sparse = isinstance(metric, SparseBrayCurtis)
    if not sparse:
        metric = get_metric(metric)
    if xi.ndim != 2 or x.ndim != 2 or xi.shape[1] != x.shape[1]:
        raise ValueError(f"expected (bm, d) and (n, d) tables, got "
                         f"{tuple(xi.shape)} and {tuple(x.shape)}")
    require(xi, "xi", torch.float32)
    require(x, "x", torch.float32)
    device = same_device(xi, x)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if sparse:
        return _sparse_panel(xi, x, metric.support, device)
    note_trace("kernels.pairwise_panel",
               (tuple(xi.shape), tuple(x.shape), metric.name, x.dtype,
                device.type))
    if device.type == "cpu":
        return pairwise_panel_ref(xi, x, metric)
    return pairwise_panel(xi, x, metric.kind)


def _row_offset(xi: torch.Tensor, x: torch.Tensor) -> int:
    """row0 where ``xi`` is the view ``x[row0 : row0 + bm]``; raises
    otherwise."""
    bm, (n, d) = xi.shape[0], x.shape
    start = xi.storage_offset() - x.storage_offset()
    row0 = start // d if d else 0
    same = xi.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
    if not (same and start == row0 * d and 0 <= row0 <= n - bm):
        raise ValueError("the sparse-support panel takes xi as a view of "
                         "rows of x, x[row0 : row0 + bm]")
    return row0


def _sparse_panel(xi, x, support, device) -> torch.Tensor:
    if (support.n, support.d) != tuple(x.shape):
        raise ValueError(f"a support of {support.n} rows and {support.d} "
                         f"features for a table of shape {tuple(x.shape)}")
    if support.values.device != device:
        raise ValueError(f"the support is on {support.values.device}, the "
                         f"table on {device}")
    row0, bm = _row_offset(xi, x), xi.shape[0]
    note_trace("kernels.pairwise_sparse_panel",
               ((bm, xi.shape[1]), tuple(x.shape), support.nnz,
                device.type))
    if device.type == "cpu":
        return pairwise_sparse_panel_ref(support, row0, bm)
    return pairwise_sparse_panel(support, row0, bm)
