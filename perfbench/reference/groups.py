"""What the references of the grouping tests share.

* ``grouping``: the labels a study's tests take, a host int64 array of n,
  the form in which a metadata column reaches a session: the input that
  ``args["grouping"]`` names, or ``args["groups"]`` contiguous groups of
  sizes that differ by at most one, sample i in group i * groups // n;
* ``distances``: the (n, n) distances the study's session holds: the input
  square ``args["matrix"]``, or for a feature table (``args["table"]``)
  the square of the production's reference distances
  (``reference/production.py``; the control's where ``control``);
* ``within_forms``: for each order o and group g, the sum of s_ij over the
  pairs i < j whose permuted labels, codes[o_i] and codes[o_j], are both g:
  under order o sample i takes the label of sample o_i, as the port
  documents its permutations;
* ``judge_test``: a test's two readings. ``<test>_gap``: the widest gap
  between a study's statistic and the reference's; where the statistic is
  an F, as a share of the reference's F or of 1, whichever is larger.
  Under the null F lies near 1 and often far below it, and a share of a
  small F grows as 1 / F with no change in the arithmetic: at n = 2048 the
  port's PERMDISP F read gaps of 4e-6 to 6e-6 of F at F = 0.09 to 0.12,
  and at most 2.2e-6 of 1 at any F (CPU, 30 seeds). ``<test>_p_outside``: for
  the studies drawn for the check, how many draws the program's count c
  (p = (c + 1) / (K + 1)) lies outside the band of the reference's null of
  that study's orders (``reference/orders.py``), each draw allowed to move
  by the gap's limit (``reference/mantel.py::band``), as for the Mantel
  test.

A test's reference is a class built from the distances, the labels and a
precision: ``"fp64"``, the reference, or ``"tf32"``, the control (every
operand of a product rounded to TF32, the sums in fp32). It gives
``observed()``, the statistic of the study's labels, and ``null(orders)``,
the (K,) statistics of the permuted labels. Every test is one-sided
(greater).
"""

import math

import numpy as np
import torch

from perfbench.reference import production
from perfbench.reference.mantel import band
from perfbench.reference.orders import permutation_orders
from perfbench.reference.workspace_pcoa import square

#: orders of one product of ``within_forms``
ORDERS_A_PRODUCT = 32


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def size(inputs: dict, args: dict) -> int:
    """The samples n of the study's distances."""
    return int(inputs[args["matrix"] if "matrix" in args
                      else args["table"]].shape[0])


def grouping(inputs: dict, args: dict, n: int) -> np.ndarray:
    if "grouping" in args:
        return np.asarray(inputs[args["grouping"]], dtype=np.int64)
    return np.arange(n, dtype=np.int64) * int(args["groups"]) // n


def distances(inputs: dict, args: dict, control: bool) -> torch.Tensor:
    if "matrix" in args:
        return inputs[args["matrix"]]
    return square(production.reference(inputs, args, control),
                  size(inputs, args))


def labels(inputs: dict, args: dict, device) -> tuple:
    """``(codes, groups)``: the labels as int64 codes in [0, groups) on
    ``device``, in the sorted order of the labels."""
    values, codes = np.unique(grouping(inputs, args, size(inputs, args)),
                              return_inverse=True)
    return torch.from_numpy(codes.astype(np.int64)).to(device), len(values)


def one_hot(codes: torch.Tensor, groups: int, dtype) -> torch.Tensor:
    """(..., n, groups) indicators of ``codes`` of shape (..., n)."""
    return (codes[..., None] == torch.arange(groups, device=codes.device)
            ).to(dtype)


def within_forms(s: torch.Tensor, codes: torch.Tensor, orders: torch.Tensor,
                 groups: int) -> torch.Tensor:
    """(K, groups) sums of the symmetric, hollow square ``s`` over each
    group's pairs under each of the (K, n) ``orders``, in ``s``'s dtype."""
    n = s.shape[0]
    out = []
    for b in range(0, orders.shape[0], ORDERS_A_PRODUCT):
        permuted = codes[orders[b:b + ORDERS_A_PRODUCT].long()]
        z = one_hot(permuted, groups, s.dtype)            # (B, n, g)
        z = z.permute(1, 0, 2).reshape(n, -1)             # (n, B g)
        forms = torch.sum(z * (s @ z), dim=0) / 2
        out.append(forms.reshape(permuted.shape[0], groups))
    return torch.cat(out)


def identity(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)[None]


def worse(worst: float, value: float) -> float:
    """The larger of two readings, a NaN the larger of any."""
    return value if not value <= worst else worst


def judge_test(test, name: str, inputs: dict, args: dict, studies, rng,
               limits: dict, control: bool, prefix: str,
               relative: bool) -> dict:
    """``{<prefix>_gap, <prefix>_p_outside}`` of the call ``name``'s
    studies, judged by the reference class ``test``."""
    tf32_off()
    gap_name, p_name = f"{prefix}_gap", f"{prefix}_p_outside"
    d = distances(inputs, args, control=False)
    codes, groups = labels(inputs, args, d.device)
    ref = test(d, codes, groups, "fp64", args)
    low = test(distances(inputs, args, control), codes, groups, "tf32",
               args) if control else None
    stat = ref.observed()
    low_stat = low.observed() if control else None
    scale = max(abs(stat), 1.0) if relative else 1.0
    done = [s for s in studies if s.outputs.get(name) is not None]
    gap = 0.0
    for study in done:
        got = low_stat if control else study.outputs[name]["statistic"]
        gap = worse(gap, abs(got - stat) / scale)
    permutations = int(args["permutations"])
    width = float(limits[gap_name]) * scale
    checked = rng.choice(len(done), size=min(int(args["checked_studies"]),
                                             len(done)), replace=False)
    p_outside = 0
    for i in sorted(checked):
        study = done[i]
        orders = permutation_orders(study.key, permutations, codes.numel(),
                                    d.device)
        lo, hi = band(ref.null(orders), stat, width, "greater")
        if control:
            c = int((low.null(orders) >= low_stat).sum())
        else:
            p = study.outputs[name]["p_value"]
            c = round(p * (permutations + 1)) - 1 if math.isfinite(p) else -1
        p_outside = max(p_outside, lo - c, c - hi)
    return {gap_name: gap, p_name: p_outside}
