"""repro_torch.obs — observability for the analysis stack.

The counterpart of ``repro/obs``, six of its seven modules:

* ``obs.config``  — ``ObsConfig``, the switchboard ``ExecConfig`` carries;
* ``obs.trace``   — nested span tracer with phase tags, JSON and Chrome
  ``trace_event`` export, an optional ``torch.profiler`` bridge, and a
  zero-overhead no-op path when disabled;
* ``obs.ledger``  — the audited analytic-traffic registry (hoist pass
  tables, Mantel per-permutation models, production feature reads),
  charged live by the instrumented stack;
* ``obs.compile`` — the call sentinel: calls and specializations per
  instrumented entry point, with a runtime guard for the "one program
  serves any K" invariant;
* ``obs.report``  — ``ObsSession`` (one run's tracer + ledger + sentinel
  window) and ``RunReport`` (one JSON per run);
* ``obs.metrics`` — fixed-footprint ``Counter``/``Gauge``/``Histogram``
  and Prometheus text export, for ``repro_torch.serve``.

``obs/probe.py`` and ``obs/drift.py`` measure XLA's compiled HLO and have
no counterpart yet.

Enable per session with ``ExecConfig(obs=ObsConfig(enabled=True))`` and
read the result with ``Workspace.report()``.
"""

from repro_torch.obs.compile import (CompileSentinel, RecompileError,
                                     note_trace, sentinel)
from repro_torch.obs.config import ObsConfig
from repro_torch.obs.ledger import (FEATURE_HOIST_PASSES, HOIST_PASSES,
                                    Ledger, LedgerEntry, hoist_floats,
                                    perm_traffic_floats, production_floats,
                                    row_stationary_floats)
from repro_torch.obs.metrics import (NULL_HISTOGRAM, Counter, Gauge,
                                     Histogram, prometheus_text)
from repro_torch.obs.report import ObsSession, RunReport, build_report
from repro_torch.obs.trace import (NULL_OBS, NULL_SPAN, PHASES, Span, Tracer,
                                   current_obs)

__all__ = [
    "CompileSentinel", "RecompileError", "note_trace", "sentinel",
    "ObsConfig",
    "FEATURE_HOIST_PASSES", "HOIST_PASSES", "Ledger", "LedgerEntry",
    "hoist_floats", "perm_traffic_floats", "production_floats",
    "row_stationary_floats",
    "Counter", "Gauge", "Histogram", "NULL_HISTOGRAM", "prometheus_text",
    "ObsSession", "RunReport", "build_report",
    "NULL_OBS", "NULL_SPAN", "PHASES", "Span", "Tracer", "current_obs",
]
