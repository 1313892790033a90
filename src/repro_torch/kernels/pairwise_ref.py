"""Plain PyTorch versions of the pairwise-panel kernel.

* ``pairwise_ref`` — the counterpart of ``repro/kernels/pairwise_ref.py``:
  the naive full-broadcast oracle, each metric written out longhand as
  ``scipy.spatial.distance`` documents it. The (n, m, d) intermediate is
  materialized whole: what the kernel exists to avoid.
* ``pairwise_panel_ref`` — the plain panel the kernel's wrapper runs on a
  CPU tensor (the counterpart of ``repro/dist/driver.py::_panel_xla``):
  sub-panels of rows stream against the whole table with the metric's
  reduce chunked over features, so the broadcast term stays bounded at
  (ROW_CHUNK, n, FEATURE_CHUNK).
"""

from __future__ import annotations

import torch

from repro_torch.dist.metrics import Metric, merge_acc

#: rows of the panel one broadcast step takes.
ROW_CHUNK = 8
#: features one broadcast step takes (the reference's default feature block).
FEATURE_CHUNK = 128


def _guarded(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def pairwise_ref(x: torch.Tensor, y: torch.Tensor, metric: str
                 ) -> torch.Tensor:
    """Distance matrix d(x_i, y_j): (n, d) × (m, d) → (n, m), eager
    broadcast formulas (0/0 conventions as in ``repro_torch.dist.metrics``)."""
    a = x[:, None, :]
    b = y[None, :, :]
    if metric == "euclidean":
        return torch.sqrt(torch.clamp_min(torch.sum((a - b) ** 2, -1), 0.0))
    if metric == "cityblock":
        return torch.sum(torch.abs(a - b), -1)
    if metric == "canberra":
        return torch.sum(_guarded(torch.abs(a - b),
                                  torch.abs(a) + torch.abs(b)), -1)
    if metric == "braycurtis":
        return _guarded(torch.sum(torch.abs(a - b), -1),
                        torch.sum(torch.abs(a + b), -1))
    if metric == "jaccard":
        dt = x.dtype
        return _guarded(torch.sum((a != b).to(dt), -1),
                        torch.sum(((a != 0) | (b != 0)).to(dt), -1))
    raise ValueError(f"unknown metric {metric!r}")


def pairwise_panel_ref(xi: torch.Tensor, x: torch.Tensor, metric: Metric
                       ) -> torch.Tensor:
    """One distance row panel: (bm, d) × (n, d) → (bm, n), the metric's
    accumulators summed one ``FEATURE_CHUNK`` chunk at a time."""
    bm, d = xi.shape
    rows = []
    for r0 in range(0, bm, ROW_CHUNK):
        p = xi[r0:r0 + ROW_CHUNK]
        acc = None
        for c0 in range(0, d, FEATURE_CHUNK):
            part = metric.accumulate(p[:, c0:c0 + FEATURE_CHUNK],
                                     x[:, c0:c0 + FEATURE_CHUNK])
            acc = part if acc is None else merge_acc(acc, part)
        if acc is None:                    # d == 0: every sum is empty
            acc = metric.accumulate(p, x)
        rows.append(metric.finish(acc))
    if not rows:
        return torch.empty((0, x.shape[0]), dtype=xi.dtype, device=xi.device)
    return torch.cat(rows)
