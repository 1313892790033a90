"""DistanceMatrix: the object both paper workloads operate on.

The counterpart of ``repro/core/distance_matrix.py``, with scikit-bio's
semantics that matter for the paper:

* construction validates the buffer (symmetric + hollow) through the fused
  single-pass check of ``core.validation`` — on the card, the ``symhollow``
  kernel;
* validation caching (§4.3): ``copy()`` and permutations of a validated
  matrix skip re-validation.

Every constructor takes ``device=``: ``None`` is the card, and there is no
silent move to the CPU when the card is missing.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.convert import from_reference
from repro_torch.core import validation
from repro_torch.kernels.dispatch import DeviceLike, resolve_device

#: int32 triangle indexing is exact only while lo*(2n − lo − 1) < 2**31;
#: past this n the closed-form condensed index would wrap, so every
#: condensed-indexed path refuses larger n. floor(sqrt(2^31)).
MAX_TRIANGLE_N = 46340
#: condensed positions ``permuted_condensed`` maps at a time (about
#: 0.2 GB of index temporaries a chunk).
PERMUTED_CHUNK = 2**22


class DistanceMatrixError(ValueError):
    """Raised when a buffer fails symmetric/hollow validation."""


class DistanceMatrix:
    """A validated, symmetric, hollow fp32 distance matrix on one device.

    ``data`` is a square contiguous fp32 tensor. ``_validated`` is the
    paper's §4.3 caching: objects derived from a validated matrix do not
    pay the validation pass again.
    """

    def __init__(self, data, ids=None, validate: bool = True,
                 _skip_validation: bool = False, device: DeviceLike = None):
        dev = resolve_device(device)
        data = torch.as_tensor(data).to(device=dev, dtype=torch.float32)
        if data.ndim != 2 or data.shape[0] != data.shape[1]:
            raise DistanceMatrixError(
                f"expected a square 2-D buffer, got {tuple(data.shape)}")
        self.data = data.contiguous()
        self.ids = tuple(ids) if ids is not None else \
            tuple(range(data.shape[0]))
        if len(self.ids) != data.shape[0]:
            raise DistanceMatrixError("ids length does not match matrix size")
        self._validated = bool(_skip_validation)
        if validate and not self._validated:
            is_sym, is_hollow = validation.is_symmetric_and_hollow(self.data)
            if not is_sym:
                raise DistanceMatrixError("matrix is not symmetric")
            if not is_hollow:
                raise DistanceMatrixError(
                    "matrix is not hollow (non-zero diagonal)")
            self._validated = True

    @classmethod
    def from_numpy(cls, data: np.ndarray, ids=None, validate: bool = True,
                   device: DeviceLike = None) -> "DistanceMatrix":
        """A matrix from a numpy array, e.g. the reference package's
        ``np.asarray(dm.data)``, through :func:`repro_torch.convert`."""
        tensor = from_reference({"data": data}, device)["data"]
        return cls(tensor, ids=ids, validate=validate, device=tensor.device)

    # -- shape helpers -----------------------------------------------------
    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __len__(self):
        return self.data.shape[0]

    # -- the paper's validation-caching trick ------------------------------
    def copy(self) -> "DistanceMatrix":
        """Copy without re-validating — paper §4.3 last paragraph."""
        return DistanceMatrix(self.data, ids=self.ids,
                              _skip_validation=self._validated,
                              device=self.device)

    # -- views --------------------------------------------------------------
    def condensed_form(self) -> torch.Tensor:
        """Upper-triangle (k=1) entries in row-major order, like scipy
        squareform."""
        return condensed_form(self.data)

    def permute(self, order, condensed: bool = False):
        """Permute rows and columns by ``order``. A permutation of a valid
        matrix is valid, so the result skips validation (paper §4.3)."""
        if isinstance(order, np.ndarray):
            order = np.ascontiguousarray(order)
        order = torch.as_tensor(order, device=self.device).long()
        permuted = self.data[order][:, order]
        if condensed:
            return condensed_form(permuted)
        return DistanceMatrix(permuted, ids=self.ids,
                              _skip_validation=self._validated,
                              device=self.device)


def condensed_form(square: torch.Tensor) -> torch.Tensor:
    """The (m,) strict upper triangle of a square matrix, scipy ``pdist``
    order, selected by a boolean mask (no index arrays)."""
    n = square.shape[0]
    mask = torch.ones((n, n), dtype=torch.bool, device=square.device).triu(1)
    return square.masked_select(mask)


def condensed_index(i: torch.Tensor, j: torch.Tensor, n: int) -> torch.Tensor:
    """Closed-form scipy-layout condensed index of pair ``(i, j)``:

        k(i, j) = lo*(2n - lo - 1)/2 + (hi - lo - 1),  lo = min, hi = max

    Elementwise over int32 tensors. Valid for ``i != j`` and
    ``n <= MAX_TRIANGLE_N`` (int32-exact)."""
    lo = torch.minimum(i, j)
    hi = torch.maximum(i, j)
    return lo * (2 * n - lo - 1) // 2 + (hi - lo - 1)


def triangle_coords(n: int, device: DeviceLike = "cpu", start: int = 0,
                    stop: Optional[int] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ii, jj) int32 tensors: the (row, col) pair of every condensed
    position k in [start, stop) (default the whole m = n(n−1)/2), in scipy
    ``pdist`` order. The inverse of ``condensed_index``, by a searchsorted
    over the n row starts S(i) = i(2n − i − 1)/2 — no (n, n) position map."""
    m = n * (n - 1) // 2
    stop = m if stop is None else stop
    if n < 2 or stop <= start:
        z = torch.zeros((0,), dtype=torch.int32, device=device)
        return z, z
    i_all = torch.arange(n, dtype=torch.int32, device=device)
    row_starts = i_all * (2 * n - i_all - 1) // 2      # S(i), increasing
    k = torch.arange(start, stop, dtype=torch.int32, device=device)
    ii = torch.searchsorted(row_starts, k, right=True, out_int32=True) - 1
    jj = k - row_starts[ii.long()] + ii + 1
    return ii, jj


def permuted_condensed(values: torch.Tensor, order: torch.Tensor,
                       n: int) -> torch.Tensor:
    """``condensed(V[order][:, order])`` for the condensed ``values`` of a
    symmetric V: ``values[tri(order[i_k], order[j_k])]`` for every k,
    ``PERMUTED_CHUNK`` positions at a time, so the index temporaries stay a
    few chunk-long vectors and no (m,) triangle map is kept."""
    m = n * (n - 1) // 2
    o = order.to(device=values.device, dtype=torch.int32)
    out = torch.empty((m,), dtype=values.dtype, device=values.device)
    for k0 in range(0, m, PERMUTED_CHUNK):
        k1 = min(k0 + PERMUTED_CHUNK, m)
        ii, jj = triangle_coords(n, values.device, k0, k1)
        out[k0:k1] = values[condensed_index(o[ii.long()], o[jj.long()],
                                            n).long()]
    return out


def condensed_to_square(condensed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``condensed_form``: symmetric matrix with zero diagonal."""
    out = torch.zeros((n, n), dtype=condensed.dtype, device=condensed.device)
    if n < 2:
        return out
    mask = torch.ones((n, n), dtype=torch.bool,
                      device=condensed.device).triu(1)
    out.masked_scatter_(mask, condensed)
    return out + out.T                     # one of each pair is zero: exact


def as_generator(seed: Union[int, torch.Generator, None],
                 default: int = 0) -> torch.Generator:
    """A CPU ``torch.Generator`` from an int seed (``None``: ``default``),
    or the generator itself. Draws are not key-compatible with JAX's."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(default if seed is None
                                         else int(seed))


def random_distance_matrix(generator: Union[int, torch.Generator, None],
                           n: int, dim: int = 8,
                           dtype: torch.dtype = torch.float32,
                           device: DeviceLike = None) -> DistanceMatrix:
    """A valid random distance matrix: Euclidean distances of random
    points drawn from ``generator`` (an int seed or a CPU generator), so
    symmetric, hollow and low-rank enough for PCoA to find."""
    dev = resolve_device(device)
    pts = torch.randn((n, dim), generator=as_generator(generator),
                      dtype=dtype).to(dev)
    sq = torch.sum(pts * pts, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (pts @ pts.T)
    d = torch.sqrt(torch.clamp_min(d2, 0.0))
    d = 0.5 * (d + d.T)                    # exact symmetry against fp noise
    d.fill_diagonal_(0.0)                  # exact hollowness
    return DistanceMatrix(d, _skip_validation=True, device=dev)
