"""The fsvd PCoA of a validated square, judged study by study.

Every study's eigenvalues and proportion explained against the fp64
reference solve with the same sketch (``perfbench.reference.fsvd``).
Readings: ``eig_gap``, the widest eigenvalue gap as a share of the largest
eigenvalue, and ``prop_gap``, the widest gap of the proportion explained.
The control is the same solve with TF32 products.
"""

from perfbench.reference import fsvd


def judge(name, inputs, args, studies, rng, limits, control=False) -> dict:
    d = inputs[args["matrix"]]
    ref = fsvd.Gram(d, "fp64")
    low = fsvd.Gram(d, "tf32") if control else None
    return fsvd.judge_studies(ref, low, name, args, studies, control)
