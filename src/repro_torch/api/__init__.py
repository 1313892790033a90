"""repro_torch.api — hoist-once analysis sessions.

The counterpart of ``repro/api``. A study runs PCoA, PERMANOVA, PERMDISP,
ANOSIM and Mantel back to back on the same distance matrix, and every
shared O(n²) hoist (the Gower centering, the operator means, the ranks,
the ordination) should run once, not once an entry point.

* ``Workspace(dm, config=ExecConfig(...))`` validates and canonicalizes
  the matrix once, then serves every analysis off a lazy ``HoistCache``;
  ``Workspace.from_features(table, metric=...)`` opens the session one
  step upstream, on condensed distances produced panel by panel.
* ``ExecConfig`` — the one home of the execution knobs.
* ``OrdinationResult`` / ``PermutationTestResult`` — the result shapes.

The free functions (``core.mantel.mantel``, ``stats.permanova``, ...)
keep their signatures and wrap a one-shot Workspace.

``config``/``results`` import nothing that imports this package back, so
core and stats can import them; ``Workspace`` loads lazily for the same
reason.
"""

from repro_torch.api.config import ExecConfig
from repro_torch.api.results import OrdinationResult

__all__ = ["ExecConfig", "OrdinationResult", "PermutationTestResult",
           "HoistCache", "Workspace"]


def __getattr__(name):
    # PEP 562: the workspace pulls in core and stats, which import
    # api.config and api.results during their own initialisation
    if name in ("Workspace", "HoistCache"):
        from repro_torch.api import workspace
        return getattr(workspace, name)
    if name == "PermutationTestResult":
        from repro_torch.stats.engine import PermutationTestResult
        return PermutationTestResult
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
