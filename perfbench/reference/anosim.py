"""ANOSIM's R (Clarke 1993), as scikit-bio defines it, plain PyTorch.

The m = n(n-1)/2 distances of the pairs i < j are ranked, ties given the
mean of the positions they share (scipy ``rankdata(method="average")``),
and with r_W and r_B the mean ranks of the pairs within a group and
between groups,

    R = (r_B - r_W) / (n (n - 1) / 4).

The rank sum within groups is the quadratic form of each group's indicator
with the square of ranks (``groups.within_forms``). Readings
(``groups.judge_test``): ``anosim_gap``, the widest gap of a study's R,
and ``anosim_p_outside``.

The reference ranks the fp32 distances exactly and sums in fp64. The
control ranks the distances rounded to TF32, rounds the ranks to TF32 as
the operands of the products, and sums in fp32.
"""

import torch

from perfbench.reference import groups
from perfbench.reference.precision import round_tf32


def average_ranks(v: torch.Tensor) -> torch.Tensor:
    """fp64 ranks from 1 of the values of ``v``, each run of equal values
    given the mean of its positions in sorted order."""
    _, inverse, counts = torch.unique(v, sorted=True, return_inverse=True,
                                      return_counts=True)
    ends = torch.cumsum(counts, dim=0)
    return ((2 * ends - counts + 1).to(torch.float64) / 2)[inverse]


class Anosim:
    def __init__(self, d: torch.Tensor, codes: torch.Tensor, num: int,
                 precision: str, args: dict):
        n = codes.numel()
        upper = torch.ones((n, n), dtype=torch.bool,
                           device=d.device).triu_(1)
        v = d[upper].to(torch.float32)
        if precision == "tf32":
            ranks = round_tf32(average_ranks(round_tf32(v)))
        else:
            ranks = average_ranks(v)
        del v
        self.r = torch.zeros((n, n), dtype=ranks.dtype, device=d.device)
        self.r[upper] = ranks
        del upper
        self.r.add_(self.r.T.clone())
        self.total = torch.sum(ranks)
        self.codes, self.groups, self.n = codes, num, n
        sizes = torch.bincount(codes, minlength=num).to(torch.float64)
        self.within = float(torch.sum(sizes * (sizes - 1) / 2))
        self.between = n * (n - 1) / 2 - self.within

    def null(self, orders: torch.Tensor) -> torch.Tensor:
        w = torch.sum(groups.within_forms(self.r, self.codes, orders,
                                          self.groups), dim=-1)
        r_w, r_b = w / self.within, (self.total - w) / self.between
        return ((r_b - r_w) / (self.n * (self.n - 1) / 4)).double().cpu()

    def observed(self) -> float:
        return float(self.null(groups.identity(self.n, self.r.device))[0])


def judge(name, inputs, args, studies, rng, limits, control=False) -> dict:
    return groups.judge_test(Anosim, name, inputs, args, studies, rng,
                             limits, control, "anosim", relative=False)
