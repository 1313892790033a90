"""ObsConfig: the observability switchboard carried by ``ExecConfig``.

The counterpart of ``repro/obs/config.py``, with the same fields and
validation. A frozen, hashable dataclass: it rides inside
``api.ExecConfig``, so it compares and hashes by value and holds no
mutable state. The mutable side (the span tree, the ledger entries) lives
in ``obs.report.ObsSession``, which a ``Workspace`` builds from this
config.

``enabled=False`` (the default) is the zero-overhead contract: a
Workspace built with it never constructs a session, every ``span()``
resolves to the shared no-op ``obs.trace.NULL_SPAN`` (or, while a torch
profiler records, to a profiler annotation) and every ledger charge is a
no-op of ``obs.trace.NULL_OBS``. The call-count sentinel
(``obs.compile``) and the profiler bridge are the always-on pieces.

This module imports nothing of ``repro_torch``, so ``api.config`` can
import it without cycles.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """What the observability layer collects for one session.

    Fields
    ------
    enabled:
        Master switch. ``False`` (default): no session is created, every
        span and charge takes the no-op path.
    spans:
        Collect the nested span tree (``obs.trace.Tracer``).
    ledger:
        Charge the analytic traffic ledger (``obs.ledger.Ledger``) at the
        instrumented call sites: hoist builds, permutation batches, the
        distance production sweep.
    annotate_xla:
        Kept so a config carries across from the reference, where it
        bridges spans into ``jax.profiler.TraceAnnotation``. It has no
        effect on the port: every span opens a
        ``torch.profiler.record_function("repro_torch." + name)`` while a
        profiler records, and costs one flag read when none does
        (``obs.trace``).
    probe:
        Measure the programs the session runs at ``Workspace.report()``
        time (``obs.probe``: one call of each on the session's device,
        with its bytes, operations and peak memory) and reconcile them
        with the port's closed forms (``obs.drift``): the report's
        ``measured`` and ``drift`` sections. ``False``: both are ``{}``.
    """

    enabled: bool = False
    spans: bool = True
    ledger: bool = True
    annotate_xla: bool = False
    probe: bool = True

    def __post_init__(self):
        for f in ("enabled", "spans", "ledger", "annotate_xla", "probe"):
            v = getattr(self, f)
            if not isinstance(v, bool):
                raise ValueError(f"ObsConfig.{f} must be a bool, "
                                 f"got {v!r}")
