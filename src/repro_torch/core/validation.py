"""Distance-matrix validation: paper §4.3, Algorithms 6 & 7.

The counterpart of ``repro/core/validation.py``.

``is_symmetric_and_hollow_ref`` reproduces the original scikit-bio code
including its memory behaviour: ``mat.T != mat`` materializes a full
boolean matrix, and the trace is a separate pass.

``is_symmetric_and_hollow`` is Algorithm 7: both checks fused into one
pass. On a CUDA tensor that pass is the hand-written ``symhollow`` kernel;
on a CPU tensor it is the kernel's plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.symhollow_ops import is_symmetric_and_hollow_op


def ensure_finite(arr: torch.Tensor, what: str = "distance matrix") -> None:
    """Raise ``ValueError`` if ``arr`` contains NaN/Inf.

    A NaN in D otherwise propagates silently into eigenvalues and into
    permutation-test p-values (NaN comparisons are all False, which
    under-counts exceedances).
    """
    if not bool(torch.isfinite(arr).all()):
        raise ValueError(
            f"{what} contains non-finite values (nan/inf); distances and "
            f"feature tables must be finite — clean the input (e.g. drop "
            f"or impute the offending samples) before analysis")


def is_symmetric_and_hollow_ref(mat: torch.Tensor) -> tuple[bool, bool]:
    """Algorithm 6 — original scikit-bio implementation (eager, multi-pass)."""
    not_sym = bool((mat.T != mat).any())
    not_hollow = bool(torch.trace(mat) != 0)
    return (not not_sym), (not not_hollow)


def is_symmetric_and_hollow(mat: torch.Tensor) -> tuple[bool, bool]:
    """Algorithm 7 — fused single-pass validation."""
    return is_symmetric_and_hollow_op(mat)


def is_symmetric_and_hollow_blocked(mat: torch.Tensor,
                                    block: int = 512) -> tuple[bool, bool]:
    """Explicitly tiled variant mirroring Algorithm 7's loop structure:
    each (i, j) tile against the transposed (j, i) tile. The structural
    reference for the kernel; a ragged n falls back to the fused pass, as
    in the reference."""
    n = mat.shape[0]
    if n % block != 0:
        return is_symmetric_and_hollow(mat)
    is_sym, is_hollow = True, True
    for i in range(0, n, block):
        for j in range(0, n, block):
            a = mat[i:i + block, j:j + block]
            b = mat[j:j + block, i:i + block]
            is_sym = is_sym and bool(torch.all(a == b.T))
            if i == j:
                is_hollow = is_hollow and bool(
                    torch.all(torch.diagonal(a) == 0))
    return is_sym, is_hollow
