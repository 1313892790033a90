"""The permutation-test engine (the rest of the battery is not ported yet)."""

from repro_torch.stats.engine import (PermutationTestResult, Statistic,
                                      permutation_orders, permutation_test)

__all__ = ["PermutationTestResult", "Statistic", "permutation_orders",
           "permutation_test"]
