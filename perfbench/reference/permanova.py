"""PERMANOVA's pseudo-F (Anderson 2001), as scikit-bio defines it, plain
PyTorch.

For n samples in g groups of sizes n_g,

    SS_T = sum_{i<j} d_ij^2 / n,
    SS_W = sum_g sum_{i<j, both in g} d_ij^2 / n_g,
    F = ((SS_T - SS_W) / (g - 1)) / (SS_W / (n - g)),

each group's sum of squares the quadratic form of its indicator with the
square of squared distances (``groups.within_forms``). The distances are
the study's square, or the production's reference distances of a feature
table. Readings (``groups.judge_test``): ``permanova_gap``, the widest gap
of a study's F as a share of the reference's F or of 1, whichever is
larger, and ``permanova_p_outside``.

The reference squares the fp32 distances in fp64 and sums in fp64. The
control rounds the distances to TF32, and their squares as the operands of
the products, and sums in fp32.
"""

import torch

from perfbench.reference import groups
from perfbench.reference.precision import round_tf32


class Permanova:
    def __init__(self, d: torch.Tensor, codes: torch.Tensor, num: int,
                 precision: str, args: dict):
        if precision == "tf32":
            dt = round_tf32(d)
            self.s = round_tf32(dt * dt)
        else:
            self.s = d.to(torch.float64) ** 2
        self.codes, self.groups, self.n = codes, num, codes.numel()
        self.sizes = torch.bincount(codes, minlength=num).to(self.s.dtype)
        self.ss_total = torch.sum(self.s) / (2 * self.n)

    def f(self, within: torch.Tensor) -> torch.Tensor:
        ss_w = torch.sum(within / self.sizes, dim=-1)
        return ((self.ss_total - ss_w) / (self.groups - 1)) / \
            (ss_w / (self.n - self.groups))

    def null(self, orders: torch.Tensor) -> torch.Tensor:
        return self.f(groups.within_forms(self.s, self.codes, orders,
                                          self.groups)).double().cpu()

    def observed(self) -> float:
        return float(self.null(groups.identity(self.n, self.s.device))[0])


def judge(name, inputs, args, studies, rng, limits, control=False) -> dict:
    return groups.judge_test(Permanova, name, inputs, args, studies, rng,
                             limits, control, "permanova", relative=True)
