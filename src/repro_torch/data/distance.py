"""Tiled distance-matrix streaming for out-of-core workloads.

The counterpart of ``repro/data/distance.py``. A 100k×100k fp32 distance
matrix is 40 GB; this stream yields (row_block, col_block) tiles of a
deterministic synthetic Euclidean distance matrix (random points, seeded),
so the tiled paths can be driven without forming the matrix anywhere.

The point of row r is a pure function of (seed, r), whatever the tile: its
``dim`` coordinates are standard normals made by Box–Muller from a
counter-based hash: normal k = r·dim + j takes SplitMix64's outputs 2k + 1
and 2k + 2 from the state ``key`` (the seed's own hash), which are pure
functions of (key, counter), computed for a whole tile at once with numpy. One numpy generator a row would cost ~10 µs a row. The
reference keys its points with ``jax.random.fold_in``, which has no torch or
numpy counterpart, so the points differ from the reference's by design
(ROADMAP.md, queue 3); the tile arithmetic (:func:`distance_tile`) is the
reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.kernels.dispatch import DeviceLike, resolve_device

_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def _mix64(z: np.ndarray) -> np.ndarray:
    """SplitMix64's finaliser of each uint64 of ``z`` (wrapping arithmetic)."""
    z = (z ^ (z >> np.uint64(30))) * _M1
    z = (z ^ (z >> np.uint64(27))) * _M2
    return z ^ (z >> np.uint64(31))


def hashed_normals(seed: int, start: int, count: int) -> np.ndarray:
    """Standard normals number start .. start + count − 1 of the stream
    ``seed``, as float64: each a pure function of (seed, its number)."""
    key = _mix64(np.array([seed], dtype=np.uint64) + _GAMMA)[0]
    i = 2 * (np.arange(count, dtype=np.uint64) + np.uint64(start))
    with np.errstate(over="ignore"):
        h1 = _mix64(key + (i + np.uint64(1)) * _GAMMA)
        h2 = _mix64(key + (i + np.uint64(2)) * _GAMMA)
    u1 = ((h1 >> np.uint64(11)).astype(np.float64) + 1.0) * 2.0 ** -53
    u2 = (h2 >> np.uint64(11)).astype(np.float64) * 2.0 ** -53
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


def distance_tile(a: torch.Tensor, b: torch.Tensor, diagonal: bool,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Euclidean distances between the rows of ``a`` (ti, dim) and ``b``
    (tj, dim), the reference's arithmetic: ``|a|² + |b|² − 2 a·bᵀ``,
    clamped at 0, square-rooted, cast to ``dtype``; a tile on the diagonal
    (``diagonal``) gets an exactly zero diagonal."""
    d2 = (torch.sum(a * a, 1)[:, None] + torch.sum(b * b, 1)[None, :]
          - 2.0 * a @ b.T)
    d = torch.sqrt(torch.clamp_min(d2, 0.0)).to(dtype)
    if diagonal:
        d.fill_diagonal_(0.0)      # exact hollowness
    return d


@dataclasses.dataclass
class DistanceTileStream:
    n: int
    dim: int = 16
    seed: int = 0
    tile: int = 4096
    dtype: str = "float32"
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _points(self, start: int, size: int) -> torch.Tensor:
        """The (size, dim) float32 points of rows start .. start + size − 1."""
        z = hashed_normals(self.seed, start * self.dim, size * self.dim)
        return torch.from_numpy(z.astype(np.float32).reshape(
            size, self.dim)).to(self.device)

    def tile_at(self, i: int, j: int) -> torch.Tensor:
        """Distance tile D[i:i+T, j:j+T] (clipped at the matrix edge)."""
        ti = min(self.tile, self.n - i)
        tj = min(self.tile, self.n - j)
        return distance_tile(self._points(i, ti), self._points(j, tj),
                             i == j, getattr(torch, self.dtype))

    def row_strip(self, i: int) -> torch.Tensor:
        """Full row strip D[i:i+T, :] assembled from tiles."""
        return torch.cat([self.tile_at(i, j)
                          for j in range(0, self.n, self.tile)], dim=1)

    def tiles(self) -> Iterator[Tuple[int, int, torch.Tensor]]:
        for i in range(0, self.n, self.tile):
            for j in range(0, self.n, self.tile):
                yield i, j, self.tile_at(i, j)

    def dense(self) -> torch.Tensor:
        """Materialize (small n only: tests)."""
        return torch.cat([self.row_strip(i)
                          for i in range(0, self.n, self.tile)], dim=0)
