"""Result dataclasses of the port's analysis entry points.

The counterpart of ``repro/api/results.py``. ``key`` records the seed that
drove the randomized solver (``None`` for the deterministic eigh path, a
caller-supplied generator, or a caller-supplied sketch). Seeds are not
key-compatible with the reference: the same seed draws other numbers in
torch than in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class OrdinationResult:
    """What every ordination entry point returns: coordinates scaled by
    √λ (scikit-bio convention), eigenvalues, the proportion of the total
    inertia each explains, the solver ("fsvd" | "eigh") and its seed."""

    coordinates: torch.Tensor           # (n, k) — samples in ordination space
    eigenvalues: torch.Tensor           # (k,)
    proportion_explained: torch.Tensor  # (k,)
    method: str = "fsvd"
    key: Optional[int] = dataclasses.field(default=None, compare=False)
