"""Straggler detection and step-time accounting.

The counterpart of ``repro/runtime/monitor.py``. Hosts that *slow down*
stretch every step that waits on them; this monitor implements the
detection half:

* rolling median step time with MAD-based outlier flagging
  (``threshold = median · k``);
* a deadline watchdog: a callable heartbeat that raises after
  ``deadline_factor × median`` so the launcher can checkpoint + evict
  (the eviction itself is the cluster scheduler's job);
* per-step records exportable for the perf logs.

The monitor is folded on the span stream: every step is a ``phase="step"`` span on an ``obs.trace.Tracer``
(the monitor's own by default, or a shared session tracer passed in),
so step timings ride the same export surface as the analysis spans —
JSON, ``Tracer.total("step")``, a torch profile's ``repro_torch.step`` —
and the
``StepRecord`` view is derived from the spans, not stored beside them.

The same watchdog covers serving: ``repro_torch.serve``'s tile
scheduler times every permutation-tile execution through a
``StepMonitor`` (``start()``/``stop()`` per tile), and the front door
calls ``heartbeat()`` between tiles so a stalled tile — one that began
but never reached ``stop()`` — trips the deadline instead of hanging the
serve loop silently. On the card a launch returns before the work is
done, so a caller's step must end with the values on the host (the
scheduler copies each tile's statistics there before ``stop()``):
otherwise the watchdog times the launch and not the work.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import List, Optional

from repro_torch.obs.metrics import Histogram
from repro_torch.obs.trace import Span, Tracer


@dataclasses.dataclass
class StepRecord:
    step: int
    seconds: float
    straggler: bool


@dataclasses.dataclass(frozen=True)
class EscalationRecord:
    """One watchdog escalation: the structured record the serve retry
    path consumes (instead of parsing a ``TimeoutError`` message).

    ``elapsed_s`` is how long the offending step had been open,
    ``deadline_s``/``median_s`` the watchdog state at escalation time,
    ``reason`` the trigger, ``aborted_open_step`` whether an open step
    span was force-closed as part of the escalation.
    """

    elapsed_s: float
    deadline_s: float
    median_s: float
    reason: str
    aborted_open_step: bool

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class DeadlineExceeded(TimeoutError):
    """``check_deadline``'s raise, now carrying the structured
    :class:`EscalationRecord` (``.record``) so the caller's recovery
    path consumes data, not a message string. Subclasses
    ``TimeoutError`` — existing ``except TimeoutError`` callers keep
    working unchanged."""

    def __init__(self, message: str, record: EscalationRecord):
        super().__init__(message)
        self.record = record


class StepMonitor:
    """Step timer + straggler flagger over a span stream.

    ``tracer`` defaults to a private ``Tracer``; pass a session's tracer
    (e.g. ``workspace.obs.tracer``) to interleave step spans with the
    analysis spans in one exported timeline.
    """

    def __init__(self, k: float = 3.0, warmup: int = 3,
                 deadline_factor: float = 10.0,
                 tracer: Optional[Tracer] = None):
        self.k = k
        self.warmup = warmup
        self.deadline_factor = deadline_factor
        self.tracer = tracer if tracer is not None else Tracer()
        self._spans: List[Span] = []         # this monitor's step spans
        self._open: Optional[Span] = None
        self.escalations: List[EscalationRecord] = []

    # -- timing ---------------------------------------------------------
    def start(self):
        self._open = self.tracer.span("step", phase="step").begin()

    def stop(self, step: int) -> StepRecord:
        if self._open is None:
            raise RuntimeError(
                "StepMonitor.stop() called before start() — call start() "
                "at the top of the step (or use record(step, seconds) "
                "for pre-measured durations)")
        span = self._open.end()
        self._open = None
        return self._flag(span, step)

    def record(self, step: int, seconds: float) -> StepRecord:
        """Append a pre-measured step (the caller timed it itself)."""
        return self._flag(
            self.tracer.record("step", seconds, phase="step"), step)

    def _flag(self, span: Span, step: int) -> StepRecord:
        base = [s.duration for s in self._spans
                if not s.attrs.get("straggler")]
        flagged = (len(base) >= self.warmup
                   and span.duration > self.k * statistics.median(base))
        span.add(step=step, straggler=flagged)
        self._spans.append(span)
        return StepRecord(step, span.duration, flagged)

    # -- watchdog ---------------------------------------------------------
    def elapsed(self) -> Optional[float]:
        """Seconds the currently-open step has been running, or ``None``
        when no step is open (between ``stop()`` and the next
        ``start()``)."""
        if self._open is None or self._open.t0 is None:
            return None
        return time.perf_counter() - self._open.t0

    def heartbeat(self) -> None:
        """The between-steps watchdog hook: if a step is open and has
        already outlived the straggler deadline, raise ``TimeoutError``.
        Drivers that interleave other work with timed steps (the
        ``repro_torch.serve`` tile loop) call this at their loop head, so a
        tile that began but never completed is detected the next time
        the loop turns instead of stalling the service silently. A
        no-op when no step is open or no median exists yet."""
        e = self.elapsed()
        if e is not None:
            self.check_deadline(e)

    # -- queries ----------------------------------------------------------
    @property
    def records(self) -> List[StepRecord]:
        """The span stream, viewed as StepRecords."""
        return [StepRecord(s.attrs["step"], s.duration,
                           s.attrs["straggler"]) for s in self._spans]

    @property
    def median(self) -> float:
        base = [s.duration for s in self._spans
                if not s.attrs.get("straggler")]
        return statistics.median(base) if base else float("nan")

    def stragglers(self) -> List[StepRecord]:
        return [r for r in self.records if r.straggler]

    def deadline(self) -> float:
        """Per-step watchdog deadline (seconds)."""
        m = self.median
        return (m * self.deadline_factor) if m == m else float("inf")

    def check_deadline(self, elapsed: float,
                       reason: str = "straggler deadline exceeded"):
        """Raise :class:`DeadlineExceeded` when ``elapsed`` outlives the
        deadline — but first *emit* the structured
        :class:`EscalationRecord` (appended to ``escalations`` and
        carried on the exception), so a recovery path consumes the
        record rather than re-deriving state from a message. The open
        step span, if any, is left open: the caller decides whether to
        ``abort()`` it (retry path) or tear the loop down."""
        d = self.deadline()
        if elapsed > d:
            rec = EscalationRecord(
                elapsed_s=elapsed, deadline_s=d, median_s=self.median,
                reason=reason, aborted_open_step=False)
            self.escalations.append(rec)
            raise DeadlineExceeded(
                f"step exceeded straggler deadline ({elapsed:.1f}s > "
                f"{d:.1f}s) — checkpoint and evict", rec)

    def abort(self, reason: str = "aborted") -> None:
        """Force-close the open step span without scoring it.

        The span still lands in the tracer (tagged ``aborted``) so the
        timeline shows the failed attempt, but it is excluded from the
        monitor's records/median — a half-run tile must not drag the
        straggler baseline."""
        if self._open is not None:
            span = self._open
            self._open = None
            span.add(aborted=True, reason=reason)
            span.end()

    def escalate(self, reason: str) -> EscalationRecord:
        """Escalate the open step *unconditionally* (no deadline check):
        emit the structured record and abort the open span. The serve
        scheduler uses this when it already *knows* a tile stalled (the
        step span survived to the next loop turn) but no median exists
        yet to arm the deadline — a watchdog that cannot fire before
        warmup would let a first-tile stall hang the service."""
        rec = EscalationRecord(
            elapsed_s=self.elapsed() or 0.0, deadline_s=self.deadline(),
            median_s=self.median, reason=reason,
            aborted_open_step=self._open is not None)
        self.escalations.append(rec)
        self.abort(reason)
        return rec

    def summary(self) -> dict:
        """Step-time distribution: exact median/p90 (kept for
        compatibility with earlier reports) plus p50/p95/p99 estimated
        through a fixed-bucket ``obs.metrics.Histogram`` — the same
        primitive the serve latency metrics use, so a monitor folded
        into ``serve_report()`` speaks the same percentile dialect."""
        secs = [s.duration for s in self._spans]
        hist = Histogram("step_seconds")
        for s in secs:
            hist.record(s)
        pct = hist.percentiles()
        return {
            "steps": len(secs),
            "median_s": self.median,
            "p90_s": (statistics.quantiles(secs, n=10)[-1]
                      if len(secs) >= 10 else max(secs, default=float("nan"))),
            "p50_s": pct.get("p50"),
            "p95_s": pct.get("p95"),
            "p99_s": pct.get("p99"),
            "stragglers": len(self.stragglers()),
            "escalations": len(self.escalations),
        }
