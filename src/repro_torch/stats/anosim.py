"""ANOSIM (Clarke 1993) on the hoisted-permutation engine.

The counterpart of ``repro/stats/anosim.py``. R = (mean between-group rank
− mean within-group rank) / (n(n−1)/4), over the ranks of the condensed
distances. The paper §4.2 split:

* **hoisted** (computed once): the ranks of the m condensed distances (one
  sort), kept condensed; the group codes, on the device; the total rank
  sum; and the within-pair count ``Σ_g n_g(n_g−1)/2``.
* **per permutation**: relabelling the samples by ``order`` makes display
  pair (i, j) a within-pair iff its permuted codes agree, so only the
  within-group rank sum changes,

      w_sum(p) = Σ_k ranks[k] · [codes[order[i_k]] == codes[order[j_k]]],

  which ``kernels.within_sums`` computes from the n codes, never forming
  an m-long indicator: on the card one launch of its kernel per tile of B
  permutations, which reads the ranks once a tile. The reference gathers
  the ORIGINAL labels' condensed indicator at each permutation's pairs
  through ``permute_reduce``; the sum is the same.

Ranks are fp32, computed as the reference computes them: ``0.5 * (lo + hi
+ 1)`` in int32, cast once. They are exact half-integers only while
2m + 1 < 2²⁴, i.e. n <= 5793; above that the cast rounds them (to a
spacing of up to 8 at n = 16384), as in the reference. Either way 2·rank
is an integer below 2³¹ (n <= 46340), so ``within_sums`` sums the doubled
ranks exactly in int64, in any order, on both devices.

``anosim_ref`` mirrors scikit-bio's eager evaluation: per permutation it
rebuilds the within-pair mask over all m pairs and takes two masked means.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.distance_matrix import (MAX_TRIANGLE_N,
                                              PERMUTED_CHUNK, DistanceMatrix,
                                              condensed_form)
from repro_torch.kernels.dispatch import DeviceLike
from repro_torch.kernels.within_sums_ops import within_sums
from repro_torch.kernels.within_sums_ref import within_sums_ref
from repro_torch.stats import engine
from repro_torch.stats.engine import PermutationTestResult


def _rank_average(v: torch.Tensor) -> torch.Tensor:
    """scipy ``rankdata(method="average")`` by one sort and two binary
    searches: ``0.5 * (lo + hi + 1)``, summed in int32 and cast once."""
    sv = torch.sort(v).values
    lo = torch.searchsorted(sv, v, side="left", out_int32=True)
    hi = torch.searchsorted(sv, v, side="right", out_int32=True)
    return 0.5 * (lo + hi + 1).to(v.dtype)


def rank_transform_condensed(flat: torch.Tensor, n: int = 0) -> dict:
    """The rank hoist straight from a condensed vector: the ranks and
    their total (``n`` is accepted as in the reference, and unused)."""
    ranks = _rank_average(flat)
    return {"ranks": ranks, "total_sum": torch.sum(ranks)}


def rank_transform(dm_data: torch.Tensor, n: int) -> dict:
    """The rank hoist from a square (n, n) matrix."""
    return rank_transform_condensed(condensed_form(dm_data))


@dataclasses.dataclass
class AnosimStatistic:
    """Clarke's R with the ranks hoisted, on the condensed batch path.

    ``dm`` may be a square (n, n) matrix, a condensed (m,) vector, or
    ``None`` when ``pre`` carries the ``rank_transform`` dict. ``grouping``
    holds the int codes in [0, num_groups) on the device of the data."""

    #: the ledger's per-permutation traffic model of this loop on the CPU
    #: (``obs.ledger.perm_traffic_floats``, the reference's gather), and on
    #: the card (``obs.ledger.within_sums_floats``, the kernel's tile)
    ledger_model = "condensed_fused"
    card_ledger_model = "within_sums"

    dm: Optional[torch.Tensor]
    grouping: torch.Tensor
    n: int
    num_groups: int
    pre: Optional[dict] = None

    def hoist(self) -> dict:
        # deferred: core.mantel imports the stats package
        from repro_torch.core.mantel import _as_condensed
        rt = self.pre if self.pre is not None else \
            rank_transform_condensed(_as_condensed(self.dm))
        ranks = rt["ranks"]
        # within_sums sums 2·rank as an exact integer: the hoist's ranks
        # are 0.5 * (lo + hi + 1) rounded once, so 2·rank is an integer of
        # at most 2m, below 2³¹ up to MAX_TRIANGLE_N
        if ranks.dtype != torch.float32 or self.n > MAX_TRIANGLE_N:
            raise ValueError(f"ANOSIM takes the fp32 ranks of n <= "
                             f"{MAX_TRIANGLE_N} samples, got {ranks.dtype} "
                             f"at n={self.n}")
        codes = self.grouping.to(device=ranks.device, dtype=torch.int32)
        sizes = torch.bincount(codes, minlength=self.num_groups).to(
            ranks.dtype)
        m = self.n * (self.n - 1) / 2.0
        within_count = torch.sum(sizes * (sizes - 1)) / 2.0
        return {"ranks": ranks, "codes": codes,
                "total_sum": rt["total_sum"], "within_count": within_count,
                "between_count": m - within_count,
                "divisor": self.n * (self.n - 1) / 4.0}

    @staticmethod
    def _finish_r(inv: dict, w_sum: torch.Tensor) -> torch.Tensor:
        r_w = w_sum / inv["within_count"]
        r_b = (inv["total_sum"] - w_sum) / inv["between_count"]
        return (r_b - r_w) / inv["divisor"]

    def per_perm(self, inv: dict, order: torch.Tensor) -> torch.Tensor:
        # the plain version on either device: the same exact sum, bit for
        # bit, as the card's kernel gives the order in a tile
        w_sum = within_sums_ref(inv["ranks"], inv["codes"], order[None],
                                PERMUTED_CHUNK)
        return self._finish_r(inv, w_sum[0])

    def per_batch(self, inv: dict, orders: torch.Tensor) -> torch.Tensor:
        return self._finish_r(inv, within_sums(inv["ranks"], inv["codes"],
                                               orders))


def anosim(dm: DistanceMatrix, grouping, permutations: int = 999,
           key: Union[int, torch.Generator, None] = None,
           batch_size: int = engine.WORKSPACE_BATCH,
           orders: Optional[torch.Tensor] = None,
           device: DeviceLike = None) -> PermutationTestResult:
    """Hoisted+fused ANOSIM on ``device`` (``None``: the card); one-sided
    (greater), like scikit-bio. ``key`` and ``orders`` as in
    ``engine.permutation_test``. A thin wrapper over a one-shot
    ``api.Workspace``: a study running several tests should hold its own
    Workspace so the rank hoist is shared."""
    from repro_torch.api.config import ExecConfig
    from repro_torch.api.workspace import Workspace
    # validate=False: trust the DistanceMatrix as constructed
    return Workspace(dm, config=ExecConfig(device=device),
                     validate=False).anosim(grouping, permutations, key,
                                            batch_size=batch_size,
                                            orders=orders)


# --------------------------------------------------------------------------
# Oracle — scikit-bio's evaluation order, deliberately eager and multi-pass
# --------------------------------------------------------------------------
def _rankdata(v: torch.Tensor) -> torch.Tensor:
    """scipy ``rankdata(method="average")`` by scipy's own algorithm: a
    stable argsort, dense ranks of the sorted run starts, and the mean of
    each tie run's first and last position."""
    sorter = torch.argsort(v, stable=True)
    inv = torch.empty_like(sorter)
    inv[sorter] = torch.arange(v.numel(), device=v.device)
    sv = v[sorter]
    obs = torch.ones_like(sv, dtype=torch.bool)
    obs[1:] = sv[1:] != sv[:-1]
    dense = torch.cumsum(obs, 0)[inv]
    count = torch.nonzero(torch.cat([obs, obs.new_ones(1)]))[:, 0]
    return (0.5 * (count[dense] + count[dense - 1] + 1).double()).to(v.dtype)


def anosim_ref(dm: DistanceMatrix, grouping, permutations: int = 999,
               key: Union[int, torch.Generator, None] = None,
               orders: Optional[torch.Tensor] = None) -> PermutationTestResult:
    """Per permutation: rebuild the within mask over all pairs, then two
    masked means, each an eager full-vector pass."""
    codes, _ = engine.encode_grouping(grouping)
    n = len(dm)
    if codes.size != n:
        raise ValueError("grouping length does not match distance matrix")
    codes = torch.from_numpy(codes).to(dm.device)
    iu = torch.triu_indices(n, n, 1, device=dm.device)
    ranks = _rankdata(dm.condensed_form())            # skbio also ranks once
    divisor = n * (n - 1) / 4.0

    def r_stat(order):
        g_p = codes[order.long()]
        within = g_p[iu[0]] == g_p[iu[1]]
        w_n = torch.sum(within)
        r_w = torch.sum(torch.where(within, ranks, 0.0)) / w_n
        r_b = torch.sum(torch.where(within, 0.0, ranks)) / (ranks.numel() - w_n)
        return (r_b - r_w) / divisor

    observed = r_stat(torch.arange(n, device=dm.device))
    if orders is None:
        orders = engine.permutation_orders(key, permutations, n, dm.device)
    permuted = torch.stack([r_stat(orders[p]) for p in range(permutations)]) \
        if permutations else torch.zeros((0,), device=dm.device)
    return engine.finish(observed, permuted, permutations, "greater", n)
