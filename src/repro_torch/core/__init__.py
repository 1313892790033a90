"""The paper's core workloads: validation, centering, matrix-free PCoA,
Mantel."""

from repro_torch.core.distance_matrix import (MAX_TRIANGLE_N, DistanceMatrix,
                                              DistanceMatrixError,
                                              condensed_index,
                                              condensed_to_square,
                                              random_distance_matrix,
                                              triangle_coords)
from repro_torch.core.operators import (CenteredGramOperator,
                                        CondensedCenteredGramOperator)
from repro_torch.core.pcoa import pcoa
from repro_torch.core.mantel import MantelStatistic, mantel

__all__ = ["MAX_TRIANGLE_N", "CenteredGramOperator",
           "CondensedCenteredGramOperator", "DistanceMatrix",
           "DistanceMatrixError", "MantelStatistic", "condensed_index",
           "condensed_to_square", "mantel", "pcoa",
           "random_distance_matrix",
           "triangle_coords"]
