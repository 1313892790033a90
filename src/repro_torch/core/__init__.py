"""The paper's core workloads: validation, centering, matrix-free PCoA,
Mantel, and their distributed forms over a device mesh."""

from repro_torch.core.distance_matrix import (MAX_TRIANGLE_N, DistanceMatrix,
                                              DistanceMatrixError,
                                              condensed_index,
                                              condensed_to_square,
                                              random_distance_matrix,
                                              triangle_coords)
from repro_torch.core.centering import (center_distance_matrix,
                                        center_distance_matrix_distributed,
                                        center_distance_matrix_ref)
from repro_torch.core.operators import (CenteredGramOperator,
                                        CondensedCenteredGramOperator,
                                        centered_gram_matvec_distributed)
from repro_torch.core.pcoa import materialized_gram, pcoa
from repro_torch.core.mantel import (MantelStatistic, hat_square, mantel,
                                     mantel_distributed)

__all__ = ["MAX_TRIANGLE_N", "CenteredGramOperator",
           "CondensedCenteredGramOperator", "DistanceMatrix",
           "DistanceMatrixError", "MantelStatistic",
           "center_distance_matrix", "center_distance_matrix_distributed",
           "center_distance_matrix_ref", "centered_gram_matvec_distributed",
           "condensed_index", "condensed_to_square", "hat_square", "mantel",
           "mantel_distributed", "materialized_gram", "pcoa",
           "random_distance_matrix", "triangle_coords"]
