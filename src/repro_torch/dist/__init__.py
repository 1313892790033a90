"""Feature tables to distances: the metrics and the panel loop."""

from repro_torch.dist.metrics import METRICS, Metric, get_metric
from repro_torch.dist.driver import (condensed_size, pairwise_condensed,
                                     pairwise_distances)

__all__ = ["METRICS", "Metric", "condensed_size", "get_metric",
           "pairwise_condensed", "pairwise_distances"]
