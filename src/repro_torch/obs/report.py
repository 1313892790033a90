"""ObsSession + RunReport: one object per run, one JSON per run.

The counterpart of ``repro/obs/report.py``, with the same JSON sections.
``ObsSession`` is the mutable counterpart of ``ObsConfig``: a tracer, a
ledger and a baseline snapshot of the process-global call sentinel, owned
by a ``Workspace`` for one run. Its ``span()`` pushes the session onto
the ambient stack (``obs.trace.current_obs``), which is how the free
functions deeper in the call chain (``stats.engine``, ``core.pcoa``,
``dist.driver``) attach their spans and ledger charges to the session
that invoked them without an argument threaded through every signature.

``RunReport`` is the assembled artifact: span tree, ledger totals,
HoistCache hit/miss snapshot and sentinel deltas, and the ``measured``
and ``drift`` sections: one ``obs.probe`` record a program the session
runs and the ``obs.drift`` verdicts on them (``{}`` when not probed). Its
ledger's ``perm:*`` entries charge the
reference's per-permutation model for tiles run on the CPU and the
row-stationary model for tiles run on the card, and the section says so
under ``perm_model``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from repro_torch.obs.compile import sentinel
from repro_torch.obs.config import ObsConfig
from repro_torch.obs.ledger import Ledger
from repro_torch.obs.trace import Tracer, profiled_span

#: What a report's ``perm:*`` ledger entries measure, stated in the report.
PERM_MODEL = ("reference model (Pallas) on the CPU: perm:* entries of "
              "tiles run there charge the reference's per-permutation "
              "gathers (condensed_fused); tiles run on the card charge the "
              "port's row-stationary permute_reduce, 4m(S*B + L) + 8nB "
              "bytes a tile of L launches (row_stationary), ANOSIM's its "
              "within_sums launches (within_sums)")


class ObsSession:
    """One run's live observability state (see module docstring)."""

    enabled = True

    def __init__(self, config: Optional[ObsConfig] = None):
        self.config = config if config is not None else ObsConfig(
            enabled=True)
        self.tracer = Tracer()
        self.ledger = Ledger()
        self.sentinel = sentinel
        self.sentinel_base = sentinel.snapshot()

    # -- spans -------------------------------------------------------------
    def span(self, name: str, phase: Optional[str] = None, **attrs):
        """A session span: entering it also makes this session ambient
        (``current_obs()``) for the enclosed call chain. With
        ``spans=False`` only a recording profiler sees it."""
        if not self.config.spans:
            return profiled_span(name)
        return self.tracer.span(name, phase, session=self, **attrs)

    # -- ledger charges (gated on config.ledger) ---------------------------
    def charge(self, op, floats, **params):
        if self.config.ledger:
            return self.ledger.charge(op, floats, **params)

    def charge_hoist(self, artifact, n, table=None):
        if self.config.ledger:
            return self.ledger.charge_hoist(artifact, n, table=table)

    def charge_perm_batch(self, op, n, permutations, batch, **params):
        if self.config.ledger:
            return self.ledger.charge_perm_batch(op, n, permutations,
                                                 batch, **params)

    def charge_production(self, n, d, block, **params):
        if self.config.ledger:
            return self.ledger.charge_production(n, d, block, **params)

    # -- sentinel ----------------------------------------------------------
    def compile_delta(self) -> dict:
        """Calls/signatures noted since this session began."""
        return self.sentinel.since(self.sentinel_base)


@dataclasses.dataclass
class RunReport:
    """One run, one document: spans + ledger + cache + call counts.

    ``meta`` carries provenance (torch and CUDA versions, the session's
    shape and device); ``spans`` is the tracer's nested dict tree;
    ``ledger`` the totals plus every entry; ``cache`` the HoistCache
    hit/miss counters; ``compile`` the sentinel's per-entry-point call
    and signature counts for the run's window; ``measured`` one probe
    record a program (``obs.probe``) and ``drift`` its verdicts
    (``obs.drift``), each ``{}`` when not probed.
    """

    meta: dict
    spans: list
    ledger: dict
    cache: dict
    compile: dict
    measured: dict = dataclasses.field(default_factory=dict)
    drift: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"meta": self.meta, "spans": self.spans,
                "ledger": self.ledger, "cache": self.cache,
                "compile": self.compile, "measured": self.measured,
                "drift": self.drift}

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, default=str)

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    # convenience accessors for the gated quantities
    @property
    def hoist_passes(self) -> float:
        return self.ledger.get("hoist_passes", 0.0)

    @property
    def total_bytes(self) -> float:
        return self.ledger.get("total_bytes", 0.0)

    def programs(self, name: str) -> int:
        return self.compile.get(name, {}).get("programs", 0)

    @property
    def drift_ok(self) -> bool:
        """True when the drift section is empty or every reconciled
        verdict landed inside its tolerance band."""
        return bool(self.drift.get("within_tolerance", True))


def _cache_section(cache) -> dict:
    """A HoistCache, stringified for JSON (tuple keys become strings)."""
    if cache is None:
        return {}
    return {
        "hits": {str(k): v for k, v in cache.hits.items()},
        "misses": {str(k): v for k, v in cache.misses.items()},
        "keys": sorted(str(k) for k in cache.keys()),
    }


def build_report(session: Optional[ObsSession] = None, cache=None,
                 meta: Optional[dict] = None,
                 measured: Optional[dict] = None,
                 drift: Optional[dict] = None) -> RunReport:
    """Assemble a ``RunReport`` from a session (tracer + ledger +
    sentinel window) and an optional HoistCache. With ``session=None``
    (observability disabled) the report still carries the cache counters
    and the sentinel's full process snapshot, with empty spans and
    ledger.

    ``measured`` is a ``{name: ProbeRecord}`` mapping from
    ``obs.probe.probe_session`` (serialized here); ``drift`` the
    ``DriftSentinel.reconcile`` section."""
    import torch

    base_meta = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if meta:
        base_meta.update(meta)
    measured_section = {name: rec.to_dict()
                        for name, rec in (measured or {}).items()}
    if session is not None:
        ledger = session.ledger.to_dict()
        ledger["perm_model"] = PERM_MODEL
        return RunReport(meta=base_meta,
                         spans=session.tracer.to_dicts(),
                         ledger=ledger,
                         cache=_cache_section(cache),
                         compile=session.compile_delta(),
                         measured=measured_section, drift=dict(drift or {}))
    return RunReport(meta=base_meta, spans=[], ledger={},
                     cache=_cache_section(cache),
                     compile=sentinel.snapshot(),
                     measured=measured_section, drift=dict(drift or {}))
