"""Pearson Mantel test of two squares, plain PyTorch.

r is Pearson's correlation of the two condensed (upper-triangle) forms.
Since the centred, normalized y-hat sums to 0, a permuted statistic is

    r_p = sum_{i<j} x[o_i, o_j] * yhat_ij / ||x - mean(x)||,

computed here as half the sum over the whole square of x gathered by the
order in rows and columns, times the square y-hat with a zero diagonal. The
orders are the port's documented draw from each study's key
(``perfbench.reference.orders``). The p-value is (c + 1) / (K + 1), c the
draws at least as extreme as r.

Readings:

* ``r_gap``: the widest gap between a study's r and the reference's;
* ``p_outside``: over the studies drawn for the check, how many draws the
  program's count c lies outside the reference's band: the count of
  reference draws beyond |r| + w and beyond |r| - w, w being the limit of
  ``r_gap``, since a draw that close to r may fall either side of it in
  another summation order.

The reference sums in fp64 over fp32 products. The control is the
reference in TF32: every product's operands rounded to TF32, the sums in
fp32.
"""

import torch

from perfbench.reference.orders import permutation_orders
from perfbench.reference.precision import round_tf32


class Moments:
    """r's pieces in one precision: the norm of x's centred condensed
    form, the square y-hat and the observed r. ``"fp64"``: fp64 moments, an
    fp32 y-hat, fp32 products summed in fp64. ``"tf32"``: fp32 moments, x
    and y-hat rounded to TF32 as the operands of every product, the sums
    in fp32."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor, precision: str):
        n = x.shape[0]
        low = precision == "tf32"
        dtype = torch.float32 if low else torch.float64
        operand = round_tf32 if low else (lambda t: t)
        upper = torch.ones((n, n), dtype=torch.bool,
                           device=x.device).triu_(1)
        xc = x[upper].to(dtype)
        xc -= xc.mean()
        self.norm_x = torch.linalg.vector_norm(xc)
        yc = y[upper].to(dtype)
        mean_y = yc.mean()
        yc -= mean_y
        norm_y = torch.linalg.vector_norm(yc)
        self.r = float(torch.sum(operand(xc) * operand(yc))
                       / (self.norm_x * norm_y))
        del xc, yc, upper
        yhat = (y.to(dtype) - mean_y) / norm_y
        yhat.fill_diagonal_(0.0)
        self.yhat = operand(yhat.to(torch.float32))
        self.x = operand(x)
        self.sum_dtype = dtype

    def null(self, orders: torch.Tensor) -> torch.Tensor:
        """(K,) permuted statistics of the given orders."""
        out = torch.empty(orders.shape[0], dtype=torch.float64)
        for i, order in enumerate(orders):
            g = self.x.index_select(0, order).index_select(1, order)
            g.mul_(self.yhat)
            out[i] = float(torch.sum(g, dtype=self.sum_dtype)
                           / (2.0 * self.norm_x))
        return out


def beyond(null: torch.Tensor, r: float, alternative: str) -> torch.Tensor:
    """Which draws are at least as extreme as ``r``."""
    if alternative == "two-sided":
        return null.abs() >= abs(r)
    if alternative == "greater":
        return null >= r
    if alternative == "less":
        return null <= r
    raise ValueError(f"unknown alternative {alternative!r}")


def band(null: torch.Tensor, r: float, width: float,
         alternative: str) -> tuple:
    """The fewest and the most draws at least as extreme as r when each
    draw may move by ``width``."""
    if alternative == "less":
        low = int(beyond(null + width, r, alternative).sum())
        high = int(beyond(null - width, r, alternative).sum())
    elif alternative == "greater":
        low = int(beyond(null - width, r, alternative).sum())
        high = int(beyond(null + width, r, alternative).sum())
    else:
        low = int((null.abs() >= abs(r) + width).sum())
        high = int((null.abs() >= abs(r) - width).sum())
    return low, high


def judge(name, inputs, args, studies, rng, limits, control=False) -> dict:
    x, y = inputs[args["x"]], inputs[args["y"]]
    ref = Moments(x, y, "fp64")
    low = Moments(x, y, "tf32") if control else None
    permutations = int(args["permutations"])
    alternative = args["alternative"]
    width = float(limits["r_gap"])
    done = [s for s in studies if s.outputs.get(name) is not None]
    r_gap = 0.0
    for study in done:
        got = low.r if control else study.outputs[name]["statistic"]
        r_gap = max(r_gap, abs(got - ref.r))
    checked = rng.choice(len(done), size=min(int(args["checked_studies"]),
                                             len(done)), replace=False)
    p_outside = 0
    for i in sorted(checked):
        study = done[i]
        orders = permutation_orders(study.key, permutations, x.shape[0],
                                    x.device)
        lo, hi = band(ref.null(orders), ref.r, width, alternative)
        if control:
            c = int(beyond(low.null(orders), low.r, alternative).sum())
        else:
            p = study.outputs[name]["p_value"]
            c = round(p * (permutations + 1)) - 1
        p_outside = max(p_outside, lo - c, c - hi)
    return {"r_gap": r_gap, "p_outside": p_outside}
