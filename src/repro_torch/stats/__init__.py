"""Distance-matrix permutation tests on one shared engine.

The counterpart of ``repro/stats``:

* ``engine``         — the shared loop: the ``Statistic`` protocol
                       (hoist / per_perm, with ``per_batch`` as the primary
                       path over padded full-size tiles), p-value
                       finishing, and the permutation axis spread over a
                       device mesh (``permutation_test_distributed``).
* ``permanova``      — pseudo-F from the centred Gower matrix (materialized
                       by the ``center`` kernel pair, or as an operator).
* ``anosim``         — Clarke's R with the ranks hoisted and kept
                       condensed; each tile is one ``within_sums``, which
                       compares the permuted group codes.
* ``permdisp``       — Anderson's dispersion F with the ordination hoisted.
* ``partial_mantel`` — three-matrix partial correlation, ŷ residualized
                       once; each tile is one S = 2 ``permute_reduce``.

``core.mantel.mantel`` is a client of the same engine. The free test
functions wrap a one-shot ``api.Workspace``, as in the reference. Each
test has an eager ``*_ref`` oracle in scikit-bio's evaluation order.
"""

from repro_torch.stats.engine import (PermutationTestResult, Statistic,
                                      encode_grouping, permutation_orders,
                                      permutation_test,
                                      permutation_test_distributed,
                                      rank_orders)
from repro_torch.stats.anosim import (AnosimStatistic, anosim, anosim_ref,
                                      rank_transform,
                                      rank_transform_condensed)
from repro_torch.stats.partial_mantel import (PartialMantelPallasStatistic,
                                              PartialMantelStatistic,
                                              partial_mantel,
                                              partial_mantel_ref)
from repro_torch.stats.permanova import (PermanovaOperatorStatistic,
                                         PermanovaStatistic, permanova,
                                         permanova_ref)
from repro_torch.stats.permdisp import (PermdispStatistic, permdisp,
                                        permdisp_ref)

__all__ = [
    "PermutationTestResult", "Statistic", "encode_grouping",
    "permutation_orders", "permutation_test",
    "permutation_test_distributed", "rank_orders",
    "AnosimStatistic", "anosim", "anosim_ref", "rank_transform",
    "rank_transform_condensed",
    "PartialMantelPallasStatistic", "PartialMantelStatistic",
    "partial_mantel", "partial_mantel_ref",
    "PermanovaOperatorStatistic", "PermanovaStatistic", "permanova",
    "permanova_ref",
    "PermdispStatistic", "permdisp", "permdisp_ref",
]
