"""Partial Mantel test (Smouse, Long & Sokal 1986) on the hoisted engine.

The counterpart of ``repro/stats/partial_mantel.py``. Correlates distance
matrices x and y while controlling for a third matrix z,

    r_xy·z = (r_xy − r_yz·r_xz) / √((1 − r_xz²)(1 − r_yz²)),

under row/column permutations of x only.

* **hoisted** (computed once, all condensed): x̄ and ‖x−x̄‖; the
  centred-normalized ŷ and ẑ; ``r_yz`` (y and z are never permuted); and
  the residualized ``ŷ_res = (ŷ − r_yz·ẑ)/√(1−r_yz²)``.
* **per permutation**: one closed-form condensed gather of the permuted x
  shared by both reductions, ``⟨x_p, ŷ_res⟩`` and ``⟨x_p, ẑ⟩``, then
  ``num/√(1−r_xz²)``. ``per_batch`` stacks (ŷ_res, ẑ) as the S = 2 rows of
  one ``permute_reduce`` call: on the card one launch of its kernel per
  tile, gathering x once for the pair.

``partial_mantel_ref`` is the classical eager evaluation: per permutation
it materializes the permuted condensed x and calls a multi-pass
``pearsonr`` three times.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.distance_matrix import (DistanceMatrix,
                                              permuted_condensed)
from repro_torch.kernels.dispatch import DeviceLike
from repro_torch.kernels.permute_reduce_ops import permute_reduce
from repro_torch.stats import engine
from repro_torch.stats.engine import PermutationTestResult

#: refuse controls with 1 − r_yz² below this: an fp32 self-correlation
#: rounds to 1 − r² as large as ~1e-6, and the residualization is 0/0.
COLLINEAR_TOL = 1e-5


@dataclasses.dataclass
class PartialMantelStatistic:
    """r_xy·z with ŷ residualized against ẑ once, outside the loop,
    square-free like ``MantelStatistic``.

    ``x``/``y``/``z`` may be square (n, n) or condensed (m,). ``pre``
    optionally carries the hoist (``{"normxm", "r_yz", "y_res", "z"}``, all
    condensed), and then ``y`` and ``z`` may be ``None``."""

    #: the ledger's per-permutation traffic model of this loop on the CPU
    #: (``obs.ledger.perm_traffic_floats``), and the invariant rows S it
    #: streams through ``permute_reduce`` (the card's row-stationary model)
    ledger_model = "condensed_fused"
    ledger_rows = 2

    x: torch.Tensor                 # permuted side
    y: Optional[torch.Tensor]       # held fixed
    z: Optional[torch.Tensor]       # held fixed (the control)
    n: int
    pre: Optional[dict] = None

    def hoist(self) -> dict:
        # deferred: core.mantel imports the stats package
        from repro_torch.core.mantel import _as_condensed, condensed_moments_vec
        inv = {"xc": _as_condensed(self.x)}
        if self.pre is not None:
            inv.update(self.pre)
        else:
            inv["normxm"] = condensed_moments_vec(inv["xc"])["norm"]
            yhat = condensed_moments_vec(_as_condensed(self.y))["hat"]
            zhat = condensed_moments_vec(_as_condensed(self.z))["hat"]
            inv.update(_residualize(yhat, zhat))
        return inv

    @staticmethod
    def _finish(inv: dict, num: torch.Tensor, xz: torch.Tensor
                ) -> torch.Tensor:
        r_xz = xz / inv["normxm"]
        return (num / inv["normxm"]) / torch.sqrt(1.0 - r_xz * r_xz)

    def per_perm(self, inv: dict, order: torch.Tensor) -> torch.Tensor:
        xg = permuted_condensed(inv["xc"], order, self.n)  # ONE gather, two dots
        return self._finish(inv, torch.dot(xg, inv["y_res"]),
                            torch.dot(xg, inv["z"]))

    def per_batch(self, inv: dict, orders: torch.Tensor) -> torch.Tensor:
        ys = torch.stack([inv["y_res"], inv["z"]])
        stats = permute_reduce(inv["xc"], ys, orders)
        return self._finish(inv, stats[0], stats[1])


@dataclasses.dataclass
class PartialMantelPallasStatistic(PartialMantelStatistic):
    """The same statistic under the name the reference gives it with its
    Pallas ``permute_reduce`` backend pinned; ``Workspace`` builds it when
    ``config.kernel == "pallas"``. In the port both names run the same
    route: each tile one S = 2 ``permute_reduce`` (the CUDA kernel on the
    card, its plain version on the CPU)."""


def _residualize(yhat: torch.Tensor, zhat: torch.Tensor) -> dict:
    """``{"r_yz", "y_res", "z"}`` from the centred-normalized fixed sides."""
    r_yz = torch.dot(yhat, zhat)
    return {"r_yz": r_yz,
            "y_res": (yhat - r_yz * zhat) / torch.sqrt(1.0 - r_yz * r_yz),
            "z": zhat}


def partial_mantel(x: DistanceMatrix, y: DistanceMatrix, z: DistanceMatrix,
                   permutations: int = 999,
                   key: Union[int, torch.Generator, None] = None,
                   alternative: str = "two-sided",
                   batch_size: int = engine.WORKSPACE_BATCH,
                   orders: Optional[torch.Tensor] = None,
                   device: DeviceLike = None) -> PermutationTestResult:
    """Hoisted+fused partial Mantel on ``device`` (``None``: the card),
    x permuted, y and z held fixed. Raises when y and z are (nearly)
    collinear. ``key`` and ``orders`` as in ``engine.permutation_test``.
    A thin wrapper over a one-shot ``api.Workspace``: sessions hold their
    own Workspace to share the normalization hoists."""
    from repro_torch.api.config import ExecConfig
    from repro_torch.api.workspace import Workspace
    # validate=False: trust the DistanceMatrix as constructed
    return Workspace(x, config=ExecConfig(device=device),
                     validate=False).partial_mantel(
        y, z, permutations, key, alternative=alternative,
        batch_size=batch_size, orders=orders)


# --------------------------------------------------------------------------
# Oracle — eager multi-pass evaluation, black-box pearsonr per permutation
# --------------------------------------------------------------------------
def partial_mantel_ref(x: DistanceMatrix, y: DistanceMatrix,
                       z: DistanceMatrix, permutations: int = 999,
                       key: Union[int, torch.Generator, None] = None,
                       alternative: str = "two-sided",
                       orders: Optional[torch.Tensor] = None
                       ) -> PermutationTestResult:
    """Per permutation: materialize the permuted condensed x and call the
    multi-pass ``pearsonr`` three times (r_xy, r_xz and r_yz, which never
    changes)."""
    from repro_torch.core.mantel import pearsonr_ref
    n = len(x)
    y_flat = y.condensed_form()
    z_flat = z.condensed_form()

    def r_partial(x_flat):
        r_xy = pearsonr_ref(x_flat, y_flat)
        r_xz = pearsonr_ref(x_flat, z_flat)
        r_yz = pearsonr_ref(y_flat, z_flat)          # recomputed every time
        return ((r_xy - r_yz * r_xz)
                / torch.sqrt((1.0 - r_xz ** 2) * (1.0 - r_yz ** 2)))

    observed = r_partial(x.condensed_form())
    if orders is None:
        orders = engine.permutation_orders(key, permutations, n, x.device)
    permuted = torch.stack([
        r_partial(x.permute(orders[p], condensed=True))
        for p in range(permutations)]) if permutations else \
        torch.zeros((0,), device=x.device)
    return engine.finish(observed, permuted, permutations, alternative, n)
