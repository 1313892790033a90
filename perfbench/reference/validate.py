"""Admission: a square is valid when it equals its transpose exactly and
its diagonal is all zeros (scikit-bio's symmetric and hollow check).

Reading ``valid_mismatch``: the verdicts of the window that differ from the
reference's. The control has no precision to lower here and gives the
reference's verdicts.
"""

import torch


def verdict(square: torch.Tensor) -> bool:
    return bool(torch.equal(square, square.T)) and \
        bool(torch.all(torch.diagonal(square) == 0))


def judge(name, inputs, args, studies, rng, limits, control=False) -> dict:
    truth = {m: verdict(inputs[m]) for m in args["matrices"]}
    mismatches = 0
    for study in studies:
        got = truth if control else study.outputs.get(name)
        if got is None:
            continue
        mismatches += sum(got[m] != truth[m] for m in truth)
    return {"valid_mismatch": mismatches}
