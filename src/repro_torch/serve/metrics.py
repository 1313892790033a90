"""ServeMetrics + serve_report: the front door's observability binding.

The counterpart of ``repro/serve/metrics.py``.

Requests overlap in time, and the ``repro_torch.obs`` tracer's nesting is
strict begin/end bracketing — so request-lifecycle timings enter the
span stream via ``Tracer.record`` (pre-timed appends, phase="serve"),
never as live overlapping spans. Per-study analytic costs (hoist
charges, per-tile permutation traffic) ride each pooled Workspace's own
``ObsSession`` ledger — the same audited terms as the library engine —
and ``serve_report()`` folds both together with the pool, queue, and
watchdog state into one service-level document.

Latency *distributions* ride ``obs.metrics.Histogram`` — fixed
log-spaced buckets, O(1) memory however long the service runs (the old
unbounded ``latencies`` list was a slow leak with a reporting API) —
one histogram each for queue wait (submit → activation), tile execution
(the scheduler's StepMonitor stopwatch), and end-to-end request latency
(submit → completion). Each may carry an SLO threshold from
``ServeConfig``; samples past it tick a breach ``Counter``. The report
carries p50/p95/p99 per distribution, and ``ServeMetrics.prometheus()``
renders the whole set as Prometheus text exposition for scraping.

* gauges — queue depth, active/admitted/completed/rejected counts,
  throughput (completed per second of service uptime), latency
  quantiles;
* latency — the three histograms' percentiles; slo — thresholds +
  breach counts;
* pool — sessions, per-study resident hoist bytes, evictions;
* scheduler — tiles executed, rows per tile, live lanes;
* studies — each pooled session's ledger totals + HoistCache counters
  (so "hoists charged once per study, not per request" is a readable
  fact, and the per-study ``RunReport`` remains available via
  ``Workspace.report()``);
* monitor — the ``StepMonitor`` summary (tile medians, p50/p95/p99,
  stragglers).
"""

from __future__ import annotations

import time
from collections import Counter as TallyCounter
from typing import Optional

from repro_torch.obs.metrics import Counter, Histogram, prometheus_text
from repro_torch.obs.trace import Tracer

#: histogram name -> ServeConfig threshold attribute
_SLO_FIELDS = {"queue_wait": "slo_queue_wait_s",
               "tile": "slo_tile_s",
               "request": "slo_request_s"}


class ServeMetrics:
    """Counters + histograms + a pre-timed span stream for one service.

    ``slo`` maps histogram names (``queue_wait`` / ``tile`` /
    ``request``) to threshold seconds; a recorded sample past its
    threshold increments the matching breach counter.
    """

    def __init__(self, slo: Optional[dict] = None):
        self.tracer = Tracer()
        self.t0 = time.perf_counter()
        self.admitted = 0          # requests accepted into the queue
        self.uploads = 0
        self.completed = 0
        self.rejections = TallyCounter()  # code -> count (timeouts too)
        self.tiles = 0
        self.tile_rows = 0
        self.tile_parts = 0
        self.queue_depth = 0
        self.slo = {k: v for k, v in (slo or {}).items() if v is not None}
        self.hist = {
            "queue_wait": Histogram("serve_queue_wait_seconds"),
            "tile": Histogram("serve_tile_seconds"),
            "request": Histogram("serve_request_seconds"),
        }
        self.breaches = {name: Counter(f"serve_slo_breach_{name}_total")
                         for name in self.hist}
        # -- fault/recovery accounting (the repro_torch.faults control plane) --
        self.faults = TallyCounter()         # injected, by "site:kind"
        self.tile_failures = TallyCounter()  # failed tile attempts, by kind
        self.retries = 0                     # tile attempts re-scheduled
        self.retried_rows = 0                # rows re-executed by retries
        self.backoff_s = 0.0                 # cumulative scheduled backoff
        self.breaker_trips = 0
        self.escalations = 0                 # watchdog stall escalations
        self.cancels = TallyCounter()        # cancellations, by code
        self.stale_terminations = 0          # stale_generation rejections
        self.resumes = 0                     # journal-recovered requests
        self.resumed_rows = 0                # rows NOT re-run thanks to it
        self.degraded = 0                    # partial-envelope terminations
        self.pool_sheds = 0                  # OOM-pressure evictions

    # -- recording ---------------------------------------------------------
    def _observe(self, name: str, seconds: float) -> None:
        self.hist[name].record(seconds)
        limit = self.slo.get(name)
        if limit is not None and seconds > limit:
            self.breaches[name].inc()

    def record_upload(self, study_id: str, n: int, seconds: float) -> None:
        self.uploads += 1
        self.tracer.record(f"upload:{study_id}", seconds, phase="serve",
                           study=study_id, n=n)

    def record_admission(self) -> None:
        self.admitted += 1

    def record_rejection(self, code: str) -> None:
        self.rejections[code] += 1

    def record_queue_wait(self, seconds: float) -> None:
        """Submit → activation delay for one request."""
        self._observe("queue_wait", seconds)

    def record_tile(self, rows: int, parts: int,
                    seconds: Optional[float] = None) -> None:
        self.tiles += 1
        self.tile_rows += rows
        self.tile_parts += parts
        if seconds is not None:
            self._observe("tile", seconds)

    def record_completion(self, handle, seconds: float) -> None:
        """A finished request: latency histogram + one pre-timed serve
        span (requests overlap, so live spans would corrupt the tracer's
        nesting stack — ``record`` appends without opening one). A
        degraded termination counts separately — its envelope is a
        partial answer, not a completion."""
        if handle.status == "degraded":
            self.degraded += 1
        else:
            self.completed += 1
        self._observe("request", seconds)
        self.tracer.record(f"request:{handle.method}", seconds,
                           phase="serve", request_id=handle.request_id,
                           study=handle.study_id,
                           permutations=handle.permutations)

    def sample_queue_depth(self, depth: int) -> None:
        self.queue_depth = depth

    # -- fault/recovery recording ------------------------------------------
    def record_fault(self, site: str, kind: str) -> None:
        """One injected fault actually firing at a site."""
        self.faults[f"{site}:{kind}"] += 1

    def record_tile_failure(self, kind: str, rows: int) -> None:
        """One failed tile attempt (injected or real); ``rows`` is the
        tile's row count — work that produced nothing."""
        self.tile_failures[kind] += 1

    def record_retry(self, rows: int, backoff_s: float) -> None:
        """A lane re-scheduled after a failed attempt: the retried rows
        feed the amplification metric, the backoff the pacing one."""
        self.retries += 1
        self.retried_rows += rows
        self.backoff_s += backoff_s

    def record_breaker(self) -> None:
        self.breaker_trips += 1

    def record_escalation(self) -> None:
        self.escalations += 1

    def record_cancel(self, code: str) -> None:
        self.cancels[code] += 1

    def record_stale(self) -> None:
        self.stale_terminations += 1

    def record_resume(self, rows: int) -> None:
        """One journal-recovered request resuming at ``rows`` draws —
        rows the rebuilt service did NOT re-execute."""
        self.resumes += 1
        self.resumed_rows += rows

    def record_shed(self) -> None:
        self.pool_sheds += 1

    @property
    def retry_amplification(self) -> float:
        """Rows re-executed by retries per successfully-executed row —
        the chaos suite's boundedness gate (a retry storm shows up here
        long before it shows up in latency)."""
        return self.retried_rows / max(1, self.tile_rows)

    def faults_report(self) -> dict:
        """The fault/recovery section of ``serve_report()``."""
        return {
            "injected": dict(self.faults),
            "tile_failures": dict(self.tile_failures),
            "retries": self.retries,
            "retried_rows": self.retried_rows,
            "retry_amplification": self.retry_amplification,
            "backoff_s": self.backoff_s,
            "breaker_trips": self.breaker_trips,
            "escalations": self.escalations,
            "cancelled": dict(self.cancels),
            "stale_terminations": self.stale_terminations,
            "resumes": self.resumes,
            "resumed_rows": self.resumed_rows,
            "degraded": self.degraded,
            "pool_sheds": self.pool_sheds,
        }

    # -- gauges ------------------------------------------------------------
    def gauges(self) -> dict:
        uptime = time.perf_counter() - self.t0
        req = self.hist["request"]
        return {
            "uptime_s": uptime,
            "queue_depth": self.queue_depth,
            "uploads": self.uploads,
            "admitted": self.admitted,
            "completed": self.completed,
            "degraded": self.degraded,
            "rejected": dict(self.rejections),
            "throughput_rps": (self.completed / uptime) if uptime else 0.0,
            "latency_s": {
                "median": req.quantile(0.5),
                "p90": req.quantile(0.9),
                "max": req.max if req.count else None,
            },
            "rows_per_tile": (self.tile_rows / self.tiles
                              if self.tiles else None),
            "requests_per_tile": (self.tile_parts / self.tiles
                                  if self.tiles else None),
        }

    def latency(self) -> dict:
        """p50/p95/p99 (+count/mean/max) per latency distribution."""
        return {f"{name}_s": h.percentiles()
                for name, h in self.hist.items()}

    def slo_report(self) -> dict:
        return {"thresholds_s": dict(self.slo),
                "breaches": {name: c.value
                             for name, c in self.breaches.items()}}

    def prometheus(self) -> str:
        """The full metric set as Prometheus text exposition."""
        return prometheus_text(list(self.hist.values()) +
                               list(self.breaches.values()))


def serve_report(service) -> dict:
    """One service-level document (see module docstring)."""
    pool, sched = service.pool, service.scheduler
    studies = {}
    for sid in pool.studies():
        ws = pool._sessions[sid]
        studies[sid] = {
            "n": ws.n,
            "generation": ws.generation,
            "cache_nbytes": ws.cache.nbytes(),
            "hoist_builds": {str(k): v for k, v in ws.cache.misses.items()},
            "hoist_hits": {str(k): v for k, v in ws.cache.hits.items()},
            "ledger": (ws.obs.ledger.totals() if ws.obs.enabled else {}),
        }
    faults = service.metrics.faults_report()
    injector = getattr(service, "injector", None)
    if injector is not None:
        faults["plan"] = {"seed": injector.plan.seed,
                          "fired": injector.summary()}
    return {
        "gauges": service.metrics.gauges(),
        "latency": service.metrics.latency(),
        "slo": service.metrics.slo_report(),
        "faults": faults,
        "pool": {
            "sessions": len(pool),
            "max_sessions": pool.max_sessions,
            "max_bytes": pool.max_bytes,
            "nbytes": pool.nbytes(),
            "nbytes_by_study": pool.nbytes_by_study(),
            "evictions": pool.evictions,
        },
        "scheduler": {
            "tiles_run": sched.tiles_run,
            "batch_size": sched.batch_size,
            "live_lanes": len(sched.lanes),
        },
        "studies": studies,
        "monitor": (sched.monitor.summary() if sched.monitor._spans
                    else {"steps": 0}),
        "spans": service.metrics.tracer.to_dicts(),
    }
