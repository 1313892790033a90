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
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.distance_matrix import (DistanceMatrix, condensed_form,
                                              permuted_condensed)
from repro_torch.kernels.dispatch import DeviceLike
from repro_torch.kernels.permute_reduce_ops import permute_reduce
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
