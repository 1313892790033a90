"""Mantel test: paper §4.2, Algorithms 3, 4 & 5.

The counterpart of ``repro/core/mantel.py``.

* ``mantel_ref`` — Algorithms 3+4: per permutation, materialize the
  permuted condensed form and run an eager multi-pass ``pearsonr``.
* ``mantel`` — Algorithm 5 as an engine ``Statistic``: ``ŷ`` is normalized
  once, ``x̄`` and ``‖x−x̄‖`` are computed once, and since ``Σŷ = 0`` each
  permuted statistic is one closed-form condensed gather and one
  multiply-reduce over the m = n(n−1)/2 entries,

      r_p = ⟨condensed(X_p), ŷ⟩ / ‖x−x̄‖,
      condensed(X_p)[k] = xc[tri(order[i_k], order[j_k])],

  batched B permutations at a time through ``permute_reduce`` — on the card
  one launch of its kernel per tile. ``mantel`` wraps a one-shot
  ``api.Workspace``, as in the reference (B = 32).
* ``mantel_distributed`` — permutations over the perm axes of a device
  mesh, ŷ's columns over ``"model"``: each rank reduces its permutations
  against its column block of the square ŷ (``hat_square``) with the
  ``mantel_corr`` kernel in column-range mode, then a fixed-order fp64 sum
  over the column axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.distance_matrix import (DistanceMatrix, condensed_form,
                                              condensed_to_square,
                                              permuted_condensed)
from repro_torch.kernels.dispatch import DeviceLike
from repro_torch.kernels.mantel_corr_ops import mantel_corr_sums_op
from repro_torch.kernels.permute_reduce_ops import permute_reduce
from repro_torch.launch.mesh import (all_gather_tiled, axis_index, axis_size,
                                     check_device, psum)
from repro_torch.stats import engine


def pearsonr_ref(x_flat: torch.Tensor, y_flat: torch.Tensor) -> torch.Tensor:
    """Eager multi-pass Pearson correlation, like scipy.stats.pearsonr."""
    xm = x_flat - x_flat.mean()
    ym = y_flat - y_flat.mean()
    xnorm = xm / torch.linalg.vector_norm(xm)
    ynorm = ym / torch.linalg.vector_norm(ym)
    return torch.dot(xnorm, ynorm)


def mantel_ref(x: DistanceMatrix, y: DistanceMatrix, permutations: int = 999,
               key: Union[int, torch.Generator, None] = None,
               alternative: str = "two-sided",
               orders: Optional[torch.Tensor] = None):
    """Original implementation: every permuted matrix is materialized and
    pearsonr re-derives mean and norm each iteration. Returns
    ``(stat, p, n)``."""
    n = len(x)
    x_flat = x.condensed_form()
    y_flat = y.condensed_form()
    orig_stat = pearsonr_ref(x_flat, y_flat)
    if orders is None:
        orders = engine.permutation_orders(key, permutations, n, x.device)
    permuted = torch.stack([
        pearsonr_ref(x.permute(orders[p], condensed=True), y_flat)
        for p in range(permutations)]) if permutations else \
        torch.zeros((0,), device=x.device)
    r = engine.finish(orig_stat, permuted, permutations, alternative, n)
    return r.statistic, r.p_value, n


def condensed_moments_vec(flat: torch.Tensor) -> dict:
    """Centred norm and centred-normalized vector of condensed distances."""
    centered = flat - flat.mean()
    norm = torch.linalg.vector_norm(centered)
    return {"norm": norm, "hat": centered / norm}


def condensed_moments(data: torch.Tensor, n: int) -> dict:
    """The O(m) permutation-invariant moments of one square matrix."""
    if data.shape != (n, n):
        raise ValueError(f"expected an ({n}, {n}) matrix, got "
                         f"{tuple(data.shape)}")
    return condensed_moments_vec(condensed_form(data))


def hat_square(moments: dict, n: int) -> torch.Tensor:
    """Square symmetric form (zero diagonal) of the centred-normalized
    condensed vector ``moments["hat"]``: the one consumer is
    ``mantel_distributed``, whose ``"model"`` axis shards its columns."""
    return condensed_to_square(moments["hat"], n)


def _as_condensed(mat: torch.Tensor) -> torch.Tensor:
    """Condensed view of a square matrix; condensed input passes through."""
    return mat if mat.ndim == 1 else condensed_form(mat)


@dataclasses.dataclass
class MantelStatistic:
    """Pearson r between permuted x and fixed y, square-free: every hoist
    and every per-permutation pass works on the m condensed entries.

    ``x``/``y`` may be square (n, n) or condensed (m,). ``pre`` optionally
    carries the hoist (``{"normxm": ..., "ynorm": ...}``, ``ynorm`` the
    condensed centred-normalized y), and then ``y`` may be ``None``."""

    #: the ledger's per-permutation traffic model of this loop on the CPU
    #: (``obs.ledger.perm_traffic_floats``), and the invariant rows S it
    #: streams through ``permute_reduce`` (the card's row-stationary model)
    ledger_model = "condensed_fused"
    ledger_rows = 1

    x: torch.Tensor
    y: Optional[torch.Tensor]
    n: int
    pre: Optional[dict] = None

    def hoist(self) -> dict:
        inv = {"xc": _as_condensed(self.x)}
        if self.pre is not None:
            inv.update(self.pre)
        else:
            xm = inv["xc"] - inv["xc"].mean()
            inv["normxm"] = torch.linalg.vector_norm(xm)
            y_flat = _as_condensed(self.y)
            ym = y_flat - y_flat.mean()
            inv["ynorm"] = ym / torch.linalg.vector_norm(ym)
        return inv

    def per_perm(self, inv: dict, order: torch.Tensor) -> torch.Tensor:
        xp = permuted_condensed(inv["xc"], order, self.n)
        return torch.dot(xp, inv["ynorm"]) / inv["normxm"]

    def per_batch(self, inv: dict, orders: torch.Tensor) -> torch.Tensor:
        stats = permute_reduce(inv["xc"], inv["ynorm"][None, :], orders)
        return stats[0] / inv["normxm"]


def mantel(x: DistanceMatrix, y: DistanceMatrix, permutations: int = 999,
           key: Union[int, torch.Generator, None] = None,
           alternative: str = "two-sided",
           orders: Optional[torch.Tensor] = None,
           device: DeviceLike = None):
    """Cache-optimized Mantel test (paper Algorithm 5) on ``device``
    (``None``: the card). Returns ``(stat, p, n)`` like the reference.

    A thin wrapper over a one-shot ``api.Workspace`` (B = 32 a tile): a
    study testing one matrix against several should hold its own
    Workspace so the normalization hoists are shared. ``key`` seeds the
    permutation orders (seed 0 by default, not key-compatible with JAX);
    ``orders`` replaces the draw with given (K, n) orders, as the parity
    tests pass the reference's."""
    from repro_torch.api.config import ExecConfig
    from repro_torch.api.workspace import Workspace
    # validate=False: trust the DistanceMatrix as constructed
    r = Workspace(x, config=ExecConfig(device=device),
                  validate=False).mantel(y, permutations=permutations,
                                         key=key, alternative=alternative,
                                         orders=orders)
    return r.statistic, r.p_value, r.sample_size


def mantel_null_distributed(x: DistanceMatrix, y: DistanceMatrix, mesh,
                            permutations: int = 1024,
                            key: Union[int, None] = None,
                            perm_axes=("data",), col_axis: str = "model",
                            orders: Optional[torch.Tensor] = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(observed, null)`` of ``mantel_distributed``: the statistic and
    the (K,) null draws, the same on every rank."""
    n = len(x)
    check_device(mesh, x.data, y.data)
    device = x.data.device
    stat = MantelStatistic(x.data, y.data, n)
    inv, observed = engine.hoist_and_observe(stat, device)
    cols = axis_size(mesh, col_axis)
    if n % cols:
        raise ValueError(f"n = {n} must divide over the {cols} ranks of "
                         f"{col_axis!r}")
    c = n // cols
    c0 = axis_index(mesh, col_axis) * c
    y_cols = hat_square({"hat": inv["ynorm"]}, n)[:, c0:c0 + c].contiguous()
    mine = engine.local_orders(key, mesh, perm_axes, permutations, n, device,
                               orders)
    sums = mantel_corr_sums_op(x.data.contiguous(), y_cols, mine, c0)
    total = psum(sums, mesh, col_axis, dtype=torch.float64).float()
    return observed, all_gather_tiled(total / (2.0 * inv["normxm"]), mesh,
                                      perm_axes)


def mantel_distributed(x: DistanceMatrix, y: DistanceMatrix, mesh,
                       permutations: int = 1024,
                       key: Union[int, None] = None,
                       alternative: str = "two-sided",
                       perm_axes=("data",), col_axis: str = "model",
                       orders: Optional[torch.Tensor] = None):
    """Permutation-parallel Mantel test over ``mesh``. Returns
    ``(stat, p, n)`` like ``mantel``.

    x is replicated; the square ŷ is sharded by columns over ``col_axis``.
    Each perm device (row-major over ``perm_axes``) owns K / P
    permutations, drawn from ``engine.rank_seed(key, dev)`` or taken from
    the given global (K, n) ``orders``, and reduces them against its column
    block with the ``mantel_corr`` kernel in column-range mode; a
    fixed-order fp64 sum over ``col_axis`` completes each draw, scaled by
    1/(2‖x−x̄‖). K must divide over the perm devices and n over
    ``col_axis``.
    """
    if alternative not in engine.ALTERNATIVES:
        raise ValueError(f"unknown alternative {alternative!r}")
    observed, null = mantel_null_distributed(x, y, mesh, permutations, key,
                                             perm_axes, col_axis, orders)
    r = engine.finish(observed, null, permutations, alternative, len(x))
    return r.statistic, r.p_value, r.sample_size
