"""Least work of the fsvd PCoA over the condensed operator of a production.

The m = n(n-1)/2 condensed fp32 distances are read once; the row means
come with the production. Each of the 2 + POWER_ITERS products with an
(n, p) block, p = min(k + 10, n), is 2 n^2 p operations (every pair feeds
both of its rows).
"""

OVERSAMPLE = 10
POWER_ITERS = 2


def count(inputs, args) -> dict:
    n = int(inputs[args["table"]].shape[0])
    p = min(int(args["dimensions"]) + OVERSAMPLE, n)
    return {"ops": (2 + POWER_ITERS) * 2 * n * n * p,
            "bytes": 4 * (n * (n - 1) // 2), "precision": "fp32"}
