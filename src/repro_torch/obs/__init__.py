"""repro_torch.obs — observability for the analysis stack.

The counterpart of ``repro/obs``, its eight modules:

* ``obs.config``  — ``ObsConfig``, the switchboard ``ExecConfig`` carries;
* ``obs.trace``   — nested span tracer with phase tags, JSON and text
  export, a ``torch.profiler`` bridge that names every span
  ``repro_torch.<name>`` in a profile while one records, and a one-flag
  no-op path otherwise;
* ``obs.ledger``  — the audited analytic-traffic registry (hoist pass
  tables, Mantel per-permutation models, production feature reads),
  charged live by the instrumented stack;
* ``obs.compile`` — the call sentinel: calls and specializations per
  instrumented entry point, with a runtime guard for the "one program
  serves any K" invariant;
* ``obs.report``  — ``ObsSession`` (one run's tracer + ledger + sentinel
  window) and ``RunReport`` (one JSON per run);
* ``obs.probe``   — the MEASURED half: one call of each program a
  session runs, its bytes (every aten op through a dispatch counter,
  every kernel launch as its wrapper declares it), operations and peak
  memory;
* ``obs.drift``   — the ``DriftSentinel`` reconciling the measured
  records with the port's closed forms, with per-backend tolerance bands;
* ``obs.metrics`` — fixed-footprint ``Counter``/``Gauge``/``Histogram``
  and Prometheus text export, for ``repro_torch.serve``.

Enable per session with ``ExecConfig(obs=ObsConfig(enabled=True))`` and
read the result with ``Workspace.report()``.
"""

from repro_torch.obs.compile import (CompileSentinel, RecompileError,
                                     note_trace, sentinel)
from repro_torch.obs.config import ObsConfig
from repro_torch.obs.drift import DriftSentinel, DriftVerdict, reconcile
from repro_torch.obs.ledger import (FEATURE_HOIST_PASSES, HOIST_PASSES,
                                    Ledger, LedgerEntry, hoist_floats,
                                    perm_traffic_floats, production_floats,
                                    row_stationary_floats)
from repro_torch.obs.metrics import (NULL_HISTOGRAM, Counter, Gauge,
                                     Histogram, prometheus_text)
from repro_torch.obs.probe import (ProbeRecord, probe_call, probe_session,
                                   probe_table)
from repro_torch.obs.report import ObsSession, RunReport, build_report
from repro_torch.obs.trace import (NULL_OBS, NULL_SPAN, PHASES, Span, Tracer,
                                   current_obs)

__all__ = [
    "CompileSentinel", "RecompileError", "note_trace", "sentinel",
    "ObsConfig",
    "DriftSentinel", "DriftVerdict", "reconcile",
    "FEATURE_HOIST_PASSES", "HOIST_PASSES", "Ledger", "LedgerEntry",
    "hoist_floats", "perm_traffic_floats", "production_floats",
    "row_stationary_floats",
    "Counter", "Gauge", "Histogram", "NULL_HISTOGRAM", "prometheus_text",
    "ProbeRecord", "probe_call", "probe_session", "probe_table",
    "ObsSession", "RunReport", "build_report",
    "NULL_OBS", "NULL_SPAN", "PHASES", "Span", "Tracer", "current_obs",
]
