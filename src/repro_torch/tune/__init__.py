"""repro_torch.tune — cost-model-driven tile solving.

The counterpart of ``repro/tune``, with the reference's exports:

* ``model``  — per-kernel closed-form traffic AND residency, the traffic
  side taken from the ``obs.ledger`` registry; the reference's Pallas
  terms beside the card's, from the CUDA kernels' own geometry;
* ``budget`` — per-backend byte budgets: the reference's columns, and the
  card's read from its properties; an optional timed calibration,
  JSON-persistable;
* ``solve``  — the solver: candidates snapped as the kernels snap them,
  the modeled resident set fit under the budget, modeled effective
  traffic minimized.

Entry point for users: ``ExecConfig(auto=True)`` (or any single knob set
to ``"auto"``): ``Workspace`` resolves it against the admitted data's
(n, d) and records the solved tiles in ``report()``.
"""

from repro_torch.tune.budget import (BackendBudget, calibrate, detect_budget,
                                     load_profile, save_profile)
from repro_torch.tune.model import (CostTerms, matvec_cost, perm_batch_cost,
                                    perm_batch_fit, production_cost,
                                    session_hoist_passes)
from repro_torch.tune.solve import (TunedTiles, resolve_exec_config,
                                    solve_tiles)

__all__ = [
    "BackendBudget", "calibrate", "detect_budget", "load_profile",
    "save_profile", "CostTerms", "matvec_cost", "perm_batch_cost",
    "perm_batch_fit", "production_cost", "session_hoist_passes",
    "TunedTiles", "resolve_exec_config", "solve_tiles",
]
