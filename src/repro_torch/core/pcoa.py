"""Principal Coordinates Analysis: paper §4.1, operator-based.

The counterpart of ``repro/core/pcoa.py``.

* ``method="fsvd"`` (default) — randomized range-finder with power
  iterations (Halko et al. 2011) driven entirely through
  ``CenteredGramOperator.matvec``: on the card every product is one launch
  of the ``center_matvec`` kernel, four per solve (Ω, two power
  iterations, the projection), and no n×n intermediate is written.
  ``materialize=True`` keeps the materialize-then-solve path.
* ``method="eigh"`` — exact symmetric eigendecomposition, the oracle; it
  always materializes the centred matrix.
* ``centering_impl="distributed"`` with a ``mesh`` — the materialized
  Gower matrix comes from ``center_distance_matrix_distributed``, and the
  matrix-free solve runs over ``centered_gram_matvec_distributed``: every
  rank holds the square and its block's work goes through the kernels.

``pcoa(None, operator=op)`` is the fully matrix-free entry: a prebuilt
operator (the condensed-backed one a feature-table production gives)
stands in for the square matrix, on the matrix-free fsvd path only. A
``Workspace`` passes its cached ``operator`` or ``gram`` so the O(n²)
hoists run once a session, and its ``ExecConfig``; the solve runs in a
``pcoa.<method>`` span of the ambient observing session.

The sketch Ω is ``omega`` when given (the parity tests pass the
reference's ``jax.random.normal(key, (n, p))``, which torch cannot
reproduce), else a standard normal draw from a CPU ``torch.Generator``
seeded by ``key`` (an int; ``None`` is the reference's default seed 42).
That draw is not key-compatible with JAX: the same seed gives another Ω.

Output mirrors scikit-bio's ``OrdinationResults``: coordinates scaled by
√λ; the proportion explained clamps negative eigenvalues to zero over the
exact total inertia ``Σλ = tr(F)``, and is 0 for the all-zero matrix.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from repro_torch.api.config import ExecConfig
from repro_torch.api.results import OrdinationResult
from repro_torch.core import centering
from repro_torch.core.distance_matrix import DistanceMatrix, as_generator
from repro_torch.core.operators import (CenteredGramOperator,
                                        CondensedCenteredGramOperator,
                                        centered_gram_matvec_distributed)
from repro_torch.core.validation import ensure_finite
from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.launch.mesh import full_tensor
from repro_torch.obs.trace import current_obs

#: extra sketch columns beyond the requested dimensions, and power steps.
OVERSAMPLE = 10
POWER_ITERS = 2
#: the reference's documented default seed of the range finder.
DEFAULT_SEED = 42


def resolve_dimensions(dimensions: Optional[int], n: int) -> int:
    """``None`` means all axes (n − 1); ``dimensions <= 0`` raises;
    ``dimensions > n`` clamps to n."""
    if dimensions is None:
        return max(n - 1, 1)
    d = int(dimensions)
    if d != dimensions:
        raise ValueError(f"dimensions must be an integer, got {dimensions!r}")
    if d <= 0:
        raise ValueError(f"dimensions must be positive, got {d}")
    return min(d, n)


def sketch_width(k: int, n: int) -> int:
    """Columns p of the range-finder sketch Ω for k dimensions."""
    return min(k + OVERSAMPLE, n)


def _subspace_iteration(matvec: Callable[[torch.Tensor], torch.Tensor],
                        omega: torch.Tensor, k: int,
                        power_iters: int = POWER_ITERS):
    """Top-k eigenpairs of a symmetric operator given only ``matvec`` and
    the (n, p) sketch: Y = AΩ, orthonormalize, power-iterate, project
    T = QᵀAQ, exact eigh of the small T, lift back."""
    q, _ = torch.linalg.qr(matvec(omega))
    for _ in range(power_iters):
        q, _ = torch.linalg.qr(matvec(q))
    t = q.T @ matvec(q)                    # (p, p) — tiny
    t = 0.5 * (t + t.T)
    evals, evecs = torch.linalg.eigh(t)
    order = torch.argsort(-evals)[:k]      # eigh is ascending; top-k
    return evals[order], (q @ evecs)[:, order]


def _exact_eigh(a: torch.Tensor, k: int):
    evals, evecs = torch.linalg.eigh(a)
    order = torch.argsort(-evals)[:k]
    return evals[order], evecs[:, order]


def materialized_gram(dm_data: torch.Tensor, centering_impl: str = "fused",
                      mesh=None) -> torch.Tensor:
    """The full Gower-centred matrix. On the card every accepted
    ``centering_impl`` runs the ``center`` kernels; on the CPU ``"ref"`` is
    the eager Algorithm 1 and ``"fused"`` the pair's plain version.
    ``"distributed"`` centres over ``mesh`` and returns the whole matrix on
    every rank (eigh and PERMANOVA consume it whole)."""
    if centering_impl == "distributed":
        if mesh is None:
            raise ValueError("distributed centering requires a mesh")
        return full_tensor(centering.center_distance_matrix_distributed(
            dm_data, mesh))
    if centering_impl not in ("ref", "fused"):
        raise ValueError(f"unknown centering_impl {centering_impl!r}")
    if centering_impl == "ref" and dm_data.device.type == "cpu":
        return centering.center_distance_matrix_ref(dm_data)
    return centering.center_distance_matrix(dm_data)


def pcoa(dm: Optional[DistanceMatrix], dimensions: int = 10,
         method: str = "fsvd", key: Union[int, torch.Generator, None] = None,
         centering_impl: str = "fused", materialize: bool = False,
         check_finite: bool = True, omega: Optional[torch.Tensor] = None,
         operator: Union[CenteredGramOperator,
                         CondensedCenteredGramOperator, None] = None,
         device: DeviceLike = None, config: Optional[ExecConfig] = None,
         gram: Optional[torch.Tensor] = None, mesh=None) -> OrdinationResult:
    """Principal Coordinates Analysis of a distance matrix, on ``device``
    (``None``: the card).

    ``method="fsvd"`` runs matrix-free against a ``CenteredGramOperator``
    unless ``materialize=True``; ``method="eigh"`` is the exact oracle.
    ``config`` (an ``ExecConfig``), when given, supplies
    ``centering_impl``, ``materialize``, ``mesh`` and the device, and those
    arguments are ignored. ``centering_impl="distributed"`` runs over
    ``mesh``, whose device type must be the device's. ``operator`` replaces the operator built from
    ``dm`` on the matrix-free path, and with ``dm=None`` stands in for the
    matrix altogether (the eigh and materialized solves then refuse: they
    need the square); ``gram`` replaces the materialized Gower matrix on
    those solves. A prebuilt artifact the taken path would ignore is an
    error. ``key`` seeds the sketch (see the module docstring); ``omega``
    replaces the draw with a given (n, min(k + 10, n)) sketch. Non-finite
    input is rejected up front unless ``check_finite=False``.
    """
    if method not in ("eigh", "fsvd"):
        raise ValueError(f"unknown method {method!r}")
    if config is not None:
        centering_impl, materialize = config.centering_impl, \
            config.materialize
        device, mesh = config.device, config.mesh
    dev = resolve_device(device)
    needs_gram = method == "eigh" or materialize
    if dm is None:
        if operator is None:
            raise ValueError("pcoa needs a DistanceMatrix or a prebuilt "
                             "operator")
        if needs_gram or centering_impl == "distributed":
            raise ValueError("dm=None (operator-only) is limited to the "
                             "matrix-free fsvd path; eigh/materialized/"
                             "distributed solves need the square matrix")
    if gram is not None and not needs_gram:
        raise ValueError("a prebuilt gram is only consumed by eigh / "
                         "materialized paths; this call runs matrix-free "
                         "(pass operator= instead)")
    if operator is not None:
        if needs_gram:
            raise ValueError("a prebuilt operator is only consumed by the "
                             "matrix-free fsvd path (pass gram= instead)")
        if operator.row_means.device.type != dev.type:
            raise ValueError(f"the operator lies on "
                             f"{operator.row_means.device}, not on {dev}")
        dev = operator.row_means.device
    if dm is not None:
        dm = dm.copy()                     # free: validation is cached
        data = dm.data.to(dev)
        if check_finite:
            ensure_finite(data)
        n = len(dm)
    else:
        n = operator.n
    k = resolve_dimensions(dimensions, n)

    def _gram():
        return (gram.to(dev) if gram is not None
                else materialized_gram(data, centering_impl, mesh))

    with current_obs().span(f"pcoa.{method}", phase="solve", n=n, k=k,
                            materialize=materialize):
        if method == "eigh":
            centered = _gram()
            evals, evecs = _exact_eigh(centered, k)
            total = torch.trace(centered)
            seed = None
        else:
            p = sketch_width(k, n)
            if omega is None:
                seed = DEFAULT_SEED if key is None else \
                    (None if isinstance(key, torch.Generator) else int(key))
                omega = torch.randn((n, p), generator=as_generator(
                    key, DEFAULT_SEED), dtype=torch.float32)
            else:
                seed = None
                if tuple(omega.shape) != (n, p):
                    raise ValueError(f"omega must be ({n}, {p}), got "
                                     f"{tuple(omega.shape)}")
            omega = omega.to(device=dev, dtype=torch.float32)
            if materialize:
                centered = _gram()
                evals, evecs = _subspace_iteration(lambda x: centered @ x,
                                                   omega, k)
                total = torch.trace(centered)
            elif centering_impl == "distributed":
                if mesh is None:
                    raise ValueError("distributed matvec requires a mesh")
                evals, evecs = _subspace_iteration(
                    lambda x: full_tensor(centered_gram_matvec_distributed(
                        data, x, mesh)), omega, k)
                total = (operator if operator is not None else
                         CenteredGramOperator.from_distance(data)).trace()
            else:
                op = operator if operator is not None else \
                    CenteredGramOperator.from_distance(data)
                evals, evecs = _subspace_iteration(op.matvec, omega, k)
                total = op.trace()

    pos = torch.clamp_min(evals, 0.0)
    coordinates = evecs * torch.sqrt(pos)[None, :]
    proportion = torch.where(total > 0, pos / total, torch.zeros_like(pos))
    return OrdinationResult(coordinates=coordinates, eigenvalues=evals,
                            proportion_explained=proportion, method=method,
                            key=seed)
