"""Least work of PERMDISP with K permutations over a square's fsvd
ordination, whatever implements it.

The ordination is counted as ``work/pcoa.py`` counts the fsvd PCoA of the
square at the test's dimensions k. Each permutation then adds each of the
n k coordinates into its group's centroid and takes it from its sample's
distance to that centroid: 2 n k operations. The square roots and the
ANOVA add O(n) a permutation that is left out.
"""

from perfbench.work import pcoa


def count(inputs, args) -> dict:
    n = int(inputs[args["matrix"]].shape[0])
    k = min(int(args["dimensions"]), n)
    ordination = pcoa.count(inputs, {"matrix": args["matrix"],
                                     "dimensions": k})
    return {"ops": ordination["ops"] + 2 * n * k * int(args["permutations"]),
            "bytes": ordination["bytes"], "precision": "fp32"}
