"""Least work of ANOSIM with K permutations, whatever implements it.

The m = n(n-1)/2 fp32 distances are read once and ranked, one operation a
rank. Each permutation's within-group rank sum takes, for each pair,
whether its permuted labels share a group and its rank summed if so: 2 m
operations. The observed statistic and the finish add O(m) that is left
out.
"""


def count(inputs, args) -> dict:
    n = int(inputs[args["matrix"]].shape[0])
    m = n * (n - 1) // 2
    return {"ops": 2 * int(args["permutations"]) * m + m, "bytes": 4 * m,
            "precision": "fp32"}
