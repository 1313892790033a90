"""The fsvd PCoA over a production's condensed distances, study by study.

The reference works out the distances itself from the table
(``reference/production.py``), builds their square in fp64 and solves it
(``reference/fsvd.py``), row means included; every study's eigenvalues and
proportion explained are judged against that solve with the study's
sketch. Readings and control as in ``reference/pcoa.py``: the control is
the same solve with TF32 products.
"""

import torch

from perfbench.reference import fsvd, production


def square(condensed: torch.Tensor, n: int) -> torch.Tensor:
    """The (n, n) fp64 square of scipy-layout condensed distances."""
    upper = torch.ones((n, n), dtype=torch.bool,
                       device=condensed.device).triu_(1)
    d = torch.zeros((n, n), dtype=torch.float64, device=condensed.device)
    d[upper] = condensed.to(torch.float64)
    del upper
    return d.add_(d.T.clone())


def judge(name, inputs, args, studies, rng, limits, control=False) -> dict:
    n = int(inputs[args["table"]].shape[0])
    d = square(production.reference(inputs, args, False), n)
    ref = fsvd.Gram(d, "fp64")
    low = fsvd.Gram(d, "tf32") if control else None
    del d
    return fsvd.judge_studies(ref, low, name, args, studies, control)
