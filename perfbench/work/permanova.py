"""Least work of PERMANOVA with K permutations, whatever implements it.

The m = n(n-1)/2 fp32 distances are read once. Each permutation's SS_W
takes, for each pair, whether its permuted labels share a group and, if
so, its squared distance summed into that group's term: 2 m operations,
in the square form and the operator form alike, and however many groups
there are. The observed statistic, SS_T and the finish add O(m) that is
left out.
"""


def count(inputs, args) -> dict:
    n = int(inputs[args["matrix"] if "matrix" in args
                   else args["table"]].shape[0])
    m = n * (n - 1) // 2
    return {"ops": 2 * int(args["permutations"]) * m, "bytes": 4 * m,
            "precision": "fp32"}
