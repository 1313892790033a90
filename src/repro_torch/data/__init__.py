"""repro_torch.data: the synthetic token pipeline of the training launcher
and the tiled synthetic distance-matrix stream."""

from repro_torch.data.distance import DistanceTileStream, distance_tile
from repro_torch.data.pipeline import TokenPipeline, make_batch_specs

__all__ = ["TokenPipeline", "make_batch_specs", "DistanceTileStream",
           "distance_tile"]
