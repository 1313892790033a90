"""Beta-diversity distance metrics, split at the chunk-accumulation boundary.

The counterpart of ``repro/dist/metrics.py``. Every metric reduces a pair
of feature vectors to a distance through the same shape: a sum over
features of an elementwise term (one or two running accumulators), then a
cheap finishing transform. A ``Metric`` declares the two hooks:

* ``accumulate(xi, xj)`` — additive accumulators for ONE feature chunk:
  ``xi`` (bm, dc) against ``xj`` (bn, dc) → dict of (bm, bn) tensors;
* ``finish(acc)`` — the (bm, bn) distance tile from the summed
  accumulators;

plus ``kind``, the integer that selects the metric's instantiation of the
``pairwise_panel`` CUDA kernel (``csrc/pairwise.cu``, enum ``Kind``: the
two numberings must agree).

Zero features are the identity for every accumulator (for Jaccard the
"either nonzero" count is 0 too), so a kernel may zero-fill the feature
tail of a tile without masking.

Degenerate-pair conventions, the reference's:

* **Bray–Curtis 0/0** — two all-zero samples are at distance 0 (SciPy ≥ 1.9
  returns NaN); the scikit-bio/QIIME convention.
* **Jaccard 0/0** — distance 0, SciPy's own convention since 1.2.
* **Canberra 0/0 terms** — per-feature 0/0 terms count as 0 (SciPy).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Protocol, runtime_checkable

import torch

Acc = Dict[str, torch.Tensor]


@runtime_checkable
class Metric(Protocol):
    """A pairwise distance metric: registry ``name``, kernel ``kind``, and
    the accumulate/finish split."""

    name: str
    kind: int

    def accumulate(self, xi: torch.Tensor, xj: torch.Tensor) -> Acc: ...

    def finish(self, acc: Acc) -> torch.Tensor: ...


def _pairwise(xi: torch.Tensor, xj: torch.Tensor):
    """Broadcast one feature chunk to per-pair terms: (bm, bn, dc)."""
    return xi[:, None, :], xj[None, :, :]


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num/den with the 0/0 → 0 convention (identical/empty samples)."""
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


@dataclasses.dataclass(frozen=True)
class Euclidean:
    """√Σ(a−b)² — difference-based, not the ‖a‖²+‖b‖²−2a·b Gram trick,
    which loses about three digits to cancellation in fp32."""

    name = "euclidean"
    kind = 0

    def accumulate(self, xi, xj):
        a, b = _pairwise(xi, xj)
        d = a - b
        return {"ss": torch.sum(d * d, dim=-1)}

    def finish(self, acc):
        return torch.sqrt(torch.clamp_min(acc["ss"], 0.0))


@dataclasses.dataclass(frozen=True)
class Cityblock:
    """Σ|a−b| (Manhattan)."""

    name = "cityblock"
    kind = 1

    def accumulate(self, xi, xj):
        a, b = _pairwise(xi, xj)
        return {"s": torch.sum(torch.abs(a - b), dim=-1)}

    def finish(self, acc):
        return acc["s"]


@dataclasses.dataclass(frozen=True)
class Canberra:
    """Σ |a−b| / (|a|+|b|), 0/0 feature terms counting 0 (SciPy)."""

    name = "canberra"
    kind = 2

    def accumulate(self, xi, xj):
        a, b = _pairwise(xi, xj)
        den = torch.abs(a) + torch.abs(b)
        return {"s": torch.sum(_safe_div(torch.abs(a - b), den), dim=-1)}

    def finish(self, acc):
        return acc["s"]


@dataclasses.dataclass(frozen=True)
class BrayCurtis:
    """Σ|a−b| / Σ|a+b| — the workhorse of microbiome beta diversity.
    0/0 (two empty samples) → 0; meant for non-negative abundances."""

    name = "braycurtis"
    kind = 3

    def accumulate(self, xi, xj):
        a, b = _pairwise(xi, xj)
        return {"num": torch.sum(torch.abs(a - b), dim=-1),
                "den": torch.sum(torch.abs(a + b), dim=-1)}

    def finish(self, acc):
        return _safe_div(acc["num"], acc["den"])


@dataclasses.dataclass(frozen=True)
class Jaccard:
    """Presence/absence disagreement #(a≠b) / #(a≠0 ∨ b≠0), the
    reference's real-vector semantics. 0/0 → 0."""

    name = "jaccard"
    kind = 4

    def accumulate(self, xi, xj):
        a, b = _pairwise(xi, xj)
        dt = xi.dtype
        return {"neq": torch.sum((a != b).to(dt), dim=-1),
                "nz": torch.sum(((a != 0) | (b != 0)).to(dt), dim=-1)}

    def finish(self, acc):
        return _safe_div(acc["neq"], acc["nz"])


def merge_acc(acc: Acc, part: Acc) -> Acc:
    """Sum two chunks' accumulators (all metrics are feature-additive)."""
    return {k: acc[k] + part[k] for k in acc}


METRICS: Dict[str, Metric] = {
    m.name: m for m in (Euclidean(), Cityblock(), Canberra(), BrayCurtis(),
                        Jaccard())
}


def get_metric(metric) -> Metric:
    """Coerce a metric name or instance to the registered ``Metric``."""
    if isinstance(metric, str):
        try:
            return METRICS[metric]
        except KeyError:
            raise ValueError(
                f"unknown metric {metric!r}; available: "
                f"{sorted(METRICS)}") from None
    if isinstance(metric, Metric):
        return metric
    raise TypeError(f"metric must be a name or Metric instance, "
                    f"got {type(metric).__name__}")
