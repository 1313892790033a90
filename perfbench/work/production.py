"""Least work of the Bray-Curtis production of an (n, d) table.

The table is read once and the m = n(n-1)/2 condensed distances written
once. For non-negative abundances sum|a - b| = sum a + sum b - 2 sum
min(a, b), and min(a, b) is 0 wherever either is 0, so what these inputs
need is one min and one add for each feature that both samples of a pair
hold (sum over features of C(nonzero_f, 2)), four operations a pair to
finish (the sums, the doubling, the difference, the division) and the n d
adds of the row sums. The count is taken from the table itself.
"""

import torch


def count(inputs, args) -> dict:
    table = inputs[args["table"]]
    n, d = (int(s) for s in table.shape)
    held = torch.count_nonzero(table, dim=0).to(torch.float64)
    shared = float(torch.sum(held * (held - 1) / 2))
    m = n * (n - 1) // 2
    return {"ops": 2 * shared + 4 * m + n * d,
            "bytes": 4 * n * d + 4 * m, "precision": "fp32"}
