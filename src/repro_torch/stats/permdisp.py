"""PERMDISP (Anderson 2006) on the hoisted-permutation engine.

The counterpart of ``repro/stats/permdisp.py``. Homogeneity of
dispersions: ordinate the distance matrix (PCoA), measure each sample's
distance to its group centroid in ordination space, and compare those
dispersions across groups with a one-way ANOVA F whose null distribution
comes from permuting the group labels.

* **hoisted** (computed once): the PCoA coordinates from ``core.pcoa``
  (matrix-free fsvd by default: on the card four ``center_matvec``
  launches), the one-hot design Z and the group sizes.
* **per permutation**: ``C = Z_pᵀX / sizes``, ``v_i = ‖x_i − C_{g(i)}‖``
  and the ANOVA F of v about its grand mean, all on the (n, k)
  coordinates. ``per_batch``
  writes the reference's vmap out as a batch dimension: one batched
  product for the tile's B centroid sets.

``permdisp_ref`` is the eager scikit-bio-style oracle: a full ``eigh``
PCoA in fp64, then per permutation a loop over groups and a one-way ANOVA
F computed as ``scipy.stats.f_oneway`` computes it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.distance_matrix import DistanceMatrix
from repro_torch.kernels.dispatch import DeviceLike
from repro_torch.stats import engine
from repro_torch.stats.engine import PermutationTestResult


@dataclasses.dataclass
class PermdispStatistic:
    """ANOVA F over distances-to-centroid, coordinates hoisted."""

    coords: torch.Tensor      # (n, k) PCoA coordinates (the expensive hoist)
    grouping: torch.Tensor    # (n,) int group codes in [0, num_groups)
    n: int
    num_groups: int

    def hoist(self) -> dict:
        z = torch.nn.functional.one_hot(
            self.grouping.to(self.coords.device).long(),
            self.num_groups).to(self.coords.dtype)
        return {"x": self.coords, "z": z, "sizes": torch.sum(z, dim=0)}

    def _f(self, inv: dict, z: torch.Tensor) -> torch.Tensor:
        """F for permuted designs z of shape (..., n, g)."""
        x, sizes = inv["x"], inv["sizes"]
        centroids = (z.transpose(-1, -2) @ x) / sizes[:, None]
        dev = x - z @ centroids                      # x_i − C_{g(i)}
        v = torch.sqrt(torch.clamp_min(torch.sum(dev * dev, dim=-1), 0.0))
        # one-way ANOVA F over the dispersions v, taken about their grand
        # mean first: where the groups barely differ their means lie a few
        # hundredths of v from it, and fp32 means of v subtracted after
        # the sums would move F by up to 8e-5 of itself (n = 16384, 4
        # groups, on an H100)
        v = v - torch.mean(v, dim=-1, keepdim=True)
        group_means = (z.transpose(-1, -2) @ v[..., None])[..., 0] / sizes
        ss_between = torch.sum(sizes * group_means ** 2, dim=-1)
        resid = v - (z @ group_means[..., None])[..., 0]
        ss_within = torch.sum(resid * resid, dim=-1)
        return (ss_between / (self.num_groups - 1)) / \
            (ss_within / (self.n - self.num_groups))

    def per_perm(self, inv: dict, order: torch.Tensor) -> torch.Tensor:
        return self._f(inv, inv["z"][order.long()])

    def per_batch(self, inv: dict, orders: torch.Tensor) -> torch.Tensor:
        return engine.fixed_products(
            lambda o: self._f(inv, inv["z"][o.long()]), orders)


def permdisp(dm: DistanceMatrix, grouping, permutations: int = 999,
             key: Union[int, torch.Generator, None] = None,
             dimensions: Optional[int] = None, method: str = "fsvd",
             batch_size: int = engine.WORKSPACE_BATCH,
             orders: Optional[torch.Tensor] = None,
             omega: Optional[torch.Tensor] = None,
             device: DeviceLike = None) -> PermutationTestResult:
    """Hoisted+fused PERMDISP on ``device`` (``None``: the card);
    one-sided (greater), like scikit-bio.

    ``dimensions`` and ``method`` go to ``core.pcoa`` (``None``: all n − 1
    axes, exact but a full-rank range finder; a small ``dimensions`` keeps
    the skinny-block cost). ``omega`` replaces the fsvd sketch, which pcoa
    otherwise draws from its fixed seed; ``key`` and ``orders`` drive only
    the permutation orders, as in ``engine.permutation_test``. A thin
    wrapper over a one-shot ``api.Workspace``: a study should hold its own
    Workspace so the ordination hoist is shared with ``ws.pcoa()``.
    """
    # deferred: the workspace imports core and stats
    from repro_torch.api.config import ExecConfig
    from repro_torch.api.workspace import Workspace
    # validate=False: trust the DistanceMatrix as constructed
    return Workspace(dm, config=ExecConfig(device=device),
                     validate=False).permdisp(grouping, permutations, key,
                                              dimensions=dimensions,
                                              method=method,
                                              batch_size=batch_size,
                                              orders=orders, omega=omega)


# --------------------------------------------------------------------------
# Oracle — scikit-bio's evaluation order, deliberately eager and multi-pass
# --------------------------------------------------------------------------
def _f_oneway(*groups: torch.Tensor) -> float:
    """One-way ANOVA F of fp64 samples, as ``scipy.stats.f_oneway``."""
    alldata = torch.cat(groups)
    offset = torch.mean(alldata)
    alldata = alldata - offset
    bign = alldata.numel()
    sstot = torch.sum(alldata ** 2) - torch.sum(alldata) ** 2 / bign
    ssbn = sum(torch.sum(g - offset) ** 2 / g.numel() for g in groups)
    ssbn = ssbn - torch.sum(alldata) ** 2 / bign
    sswn = sstot - ssbn
    dfbn = len(groups) - 1
    dfwn = bign - len(groups)
    return float((ssbn / dfbn) / (sswn / dfwn))


def permdisp_ref(dm: DistanceMatrix, grouping, permutations: int = 999,
                 key: Union[int, torch.Generator, None] = None,
                 dimensions: Optional[int] = None,
                 orders: Optional[torch.Tensor] = None
                 ) -> PermutationTestResult:
    """Full eager ``eigh`` PCoA, then per permutation a Python loop over
    groups (centroid, distances) and a black-box one-way ANOVA F."""
    from repro_torch.core.centering import center_distance_matrix_ref
    from repro_torch.core.pcoa import resolve_dimensions

    codes, num_groups = engine.encode_grouping(grouping)
    n = len(dm)
    if codes.size != n:
        raise ValueError("grouping length does not match distance matrix")
    codes = torch.from_numpy(codes).to(dm.device)
    dims = resolve_dimensions(dimensions, n)

    centered = center_distance_matrix_ref(dm.data).double()
    evals, evecs = torch.linalg.eigh(centered)
    top = torch.argsort(-evals)[:dims]
    coords = evecs[:, top] * torch.sqrt(torch.clamp_min(evals[top], 0.0))

    def f_stat(perm):
        g_p = codes[perm.long()]
        v = torch.empty(n, dtype=torch.float64, device=dm.device)
        for g in range(num_groups):                  # one pass per group
            mask = g_p == g
            c = coords[mask].mean(dim=0)
            v[mask] = torch.linalg.vector_norm(coords[mask] - c, dim=1)
        return _f_oneway(*(v[g_p == g] for g in range(num_groups)))

    observed = f_stat(torch.arange(n, device=dm.device))
    if orders is None:
        orders = engine.permutation_orders(key, permutations, n, dm.device)
    permuted = torch.tensor([f_stat(orders[p]) for p in range(permutations)],
                            dtype=torch.float32, device=dm.device)
    return engine.finish(torch.tensor(observed, dtype=torch.float32),
                         permuted, permutations, "greater", n)
