"""Allocation-light metric primitives: Counter / Gauge / Histogram.

The counterpart of ``repro/obs/metrics.py``, pure Python as it is.
``repro_torch.serve`` needs latency *distributions* (p50/p95/p99 for queue
wait, tile execution, end-to-end requests), and ``runtime.monitor``
needs the same percentiles over step durations — but a serve loop that
appends every sample to an unbounded list is a slow leak with a
reporting API. These primitives are fixed-footprint by construction:

* ``Histogram`` — fixed log-spaced buckets allocated once at
  construction; ``record()`` is a bisect + three integer/float updates,
  no allocation on the hot path. Quantiles are interpolated within the
  landing bucket and clamped to the exact observed ``[min, max]``, so
  they are estimates with bounded error (one bucket width) at O(1)
  memory, whatever the sample count.
* ``Counter`` / ``Gauge`` — named scalars with the same ``to_dict`` /
  Prometheus surface, so breach counts and queue depths export beside
  the distributions.
* ``NULL_HISTOGRAM`` — the disabled fast path, mirroring
  ``obs.trace.NULL_SPAN``: a shared singleton whose ``record()`` is a
  no-op method call, allocation-free, so call sites never branch.

Export: ``to_dict()`` everywhere (JSON, rides ``serve_report()``), and
``prometheus_text()`` renders any mix of the three as Prometheus
text-exposition format (cumulative ``_bucket{le=...}`` lines, ``_sum``,
``_count``) for scraping without adding a client library dependency.

This module imports nothing of the package (and nothing heavier than
``bisect``), like ``obs.config``, so any layer may use it.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Iterable, Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "NULL_HISTOGRAM",
           "DEFAULT_LATENCY_BUCKETS", "prometheus_text"]

#: half-decade log-spaced seconds, 10µs .. 100s — wide enough for a
#: sub-ms tile and a multi-minute drain with one shared shape
DEFAULT_LATENCY_BUCKETS = tuple(10.0 ** (k / 2.0) for k in range(-10, 5))


class Counter:
    """A named monotone count (rejections, SLO breaches, tiles)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: float = 0):
        self.name = name
        self.value = value

    def inc(self, amount: float = 1) -> None:
        self.value += amount

    def to_dict(self) -> dict:
        return {"name": self.name, "type": "counter", "value": self.value}


class Gauge:
    """A named last-written value (queue depth, resident bytes)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: Optional[float] = None):
        self.name = name
        self.value = value

    def set(self, value: float) -> None:
        self.value = value

    def to_dict(self) -> dict:
        return {"name": self.name, "type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket distribution (see module docstring).

    ``buckets`` are ascending upper edges; one overflow bucket catches
    everything past the last edge. ``record()`` is the hot path:
    bisect into the pre-allocated count list, update count/sum/min/max.
    """

    __slots__ = ("name", "buckets", "counts", "count", "sum", "min", "max")

    enabled = True

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"buckets must be ascending, got {buckets!r}")
        self.name = name
        self.buckets = b
        self.counts = [0] * (len(b) + 1)       # + overflow
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    # -- hot path ----------------------------------------------------------
    def record(self, value: float) -> None:
        self.counts[bisect_left(self.buckets, value)] += 1
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    # -- queries -----------------------------------------------------------
    def quantile(self, q: float) -> Optional[float]:
        """Interpolated q-quantile (0 < q <= 1), clamped to the observed
        [min, max]; ``None`` while empty."""
        if self.count == 0:
            return None
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self.max)
                frac = (rank - cum) / c
                v = lo + frac * (hi - lo)
                return min(max(v, self.min), self.max)
            cum += c
        return self.max

    def percentiles(self) -> dict:
        return {"count": self.count,
                "p50": self.quantile(0.50),
                "p95": self.quantile(0.95),
                "p99": self.quantile(0.99),
                "mean": (self.sum / self.count) if self.count else None,
                "max": (self.max if self.count else None)}

    def to_dict(self) -> dict:
        return {"name": self.name, "type": "histogram",
                "buckets": list(self.buckets), "counts": list(self.counts),
                **self.percentiles()}


class _NullHistogram:
    """The disabled fast path — record() is a no-op, allocation-free.
    A shared singleton (``NULL_HISTOGRAM``), like ``NULL_SPAN``."""

    __slots__ = ()

    enabled = False
    count = 0
    sum = 0.0

    def record(self, value: float) -> None:
        pass

    def quantile(self, q: float) -> None:
        return None

    def percentiles(self) -> dict:
        return {}

    def to_dict(self) -> dict:
        return {}


NULL_HISTOGRAM = _NullHistogram()


# --------------------------------------------------------------------------
# Prometheus text exposition (no client-library dependency)
# --------------------------------------------------------------------------
def _fmt(v: float) -> str:
    return repr(float(v)) if v == v else "NaN"


def _sanitize(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def prometheus_text(metrics: Iterable) -> str:
    """Render Counters/Gauges/Histograms as Prometheus text format:
    ``# TYPE`` headers, cumulative ``_bucket{le="..."}`` series with the
    ``+Inf`` bucket, ``_sum`` and ``_count`` — scrapeable as-is."""
    lines = []
    for m in metrics:
        name = _sanitize(m.name)
        if isinstance(m, Histogram):
            lines.append(f"# TYPE {name} histogram")
            cum = 0
            for edge, c in zip(m.buckets, m.counts):
                cum += c
                lines.append(f'{name}_bucket{{le="{_fmt(edge)}"}} {cum}')
            lines.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
            lines.append(f"{name}_sum {_fmt(m.sum)}")
            lines.append(f"{name}_count {m.count}")
        elif isinstance(m, Counter):
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {_fmt(m.value)}")
        elif isinstance(m, Gauge):
            lines.append(f"# TYPE {name} gauge")
            v = m.value if m.value is not None else float("nan")
            lines.append(f"{name} {_fmt(v)}")
    return "\n".join(lines) + ("\n" if lines else "")
