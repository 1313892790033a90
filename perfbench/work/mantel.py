"""Least work of a Pearson Mantel test with K permutations.

Each of the two (n, n) fp32 inputs is read once. Each permuted statistic
is one product and one sum over the m = n(n-1)/2 pairs (2 m operations);
the observed statistic and the moments add O(m) that is left out.
"""


def count(inputs, args) -> dict:
    n = int(inputs[args["x"]].shape[0])
    m = n * (n - 1) // 2
    return {"ops": 2 * int(args["permutations"]) * m,
            "bytes": 2 * 4 * n * n, "precision": "fp32"}
