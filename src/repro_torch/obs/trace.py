"""Span tracer: nested host-time spans with phase tags and cost attrs.

The counterpart of ``repro/obs/trace.py``. A ``Span`` records the host's
wall time (``perf_counter``) and a phase tag from the analysis stack's
vocabulary:

* ``hoist``      — a permutation-invariant O(n²)/O(m) artifact build
  (the HoistCache miss path);
* ``per_perm``   — a Monte-Carlo permutation loop (the stats engine);
* ``production`` — the feature-table → condensed-distance sweep
  (``repro_torch.dist``);
* ``solve``      — an eigensolve / subspace iteration (``core.pcoa``);
* ``step``       — a training/serving step;
* ``serve``      — front-door work of a serving layer.

Spans read the host clock, as in the reference. On the card, kernels run
asynchronously, so a span measures the time until the host moved on — its
launches plus whatever synchronised inside it — not the time the card
spent. For device time, every span bridges into ``torch.profiler``: while
a profiler records, each span — a session's, a bare ``Tracer``'s, or the
no-op session's — opens ``torch.profiler.record_function("repro_torch." +
name)`` for its duration, so the profile's Chrome trace carries the spans
beside the kernels they launched, on the clock the device trace is aligned
to. The bridge follows the profiler alone: no configuration turns it on or
off.

Spans nest (a ``ws.permanova`` span holds its ``hoist:gram`` child and
the engine's ``per_perm`` span), and export as plain dicts / JSON and as
indented text lines.

The no-op fast path lets every call site stay instrumented: with no
active session and no profiler recording, ``current_obs()`` returns the
shared ``NULL_OBS``, whose ``span()`` reads one flag and returns the shared
``NULL_SPAN``: no allocation a call.

This module imports nothing of ``repro_torch`` (torch only, for the
profiler bridge), so any layer can import it without cycles.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

#: the phase vocabulary — see the module docstring
PHASES = ("hoist", "per_perm", "production", "solve", "step", "serve")
#: what a span's name carries in a torch profile
PROFILE_PREFIX = "repro_torch."


def profiling() -> bool:
    """True while a ``torch.profiler`` records: one module flag read."""
    return _autograd_profiler._is_profiler_enabled


def _annotation(name: str):
    """An entered ``record_function`` under the span's profile name."""
    ann = torch.profiler.record_function(PROFILE_PREFIX + name)
    ann.__enter__()
    return ann


class Span:
    """One timed, attributed, nestable region.

    Use as a context manager (``with tracer.span(...)``) or drive
    ``begin()``/``end()`` explicitly (a step monitor's style). Attrs
    are free-form key→value pairs: impl/backend tags, analytic cost
    terms, shapes. ``add()`` attaches more after creation (e.g. a result
    computed inside the span).
    """

    __slots__ = ("name", "phase", "attrs", "t0", "duration", "children",
                 "_tracer", "_session", "_ann")

    def __init__(self, tracer: "Tracer", name: str,
                 phase: Optional[str] = None, session=None, **attrs):
        if phase is not None and phase not in PHASES:
            raise ValueError(f"unknown span phase {phase!r}; "
                             f"expected one of {PHASES} or None")
        self.name = name
        self.phase = phase
        self.attrs = attrs
        self.t0: Optional[float] = None
        self.duration: Optional[float] = None
        self.children: list = []
        self._tracer = tracer
        self._session = session
        self._ann = None

    # -- lifecycle ---------------------------------------------------------
    def begin(self) -> "Span":
        self.t0 = time.perf_counter()
        self._tracer._open(self)
        if self._session is not None:
            push_obs(self._session)
        if profiling():
            self._ann = _annotation(self.name)
        return self

    def end(self) -> "Span":
        if self.t0 is None:
            raise RuntimeError(f"span {self.name!r} ended before begin()")
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            self._ann = None
        if self._session is not None:
            pop_obs(self._session)
        self.duration = time.perf_counter() - self.t0
        self._tracer._close(self)
        return self

    def __enter__(self) -> "Span":
        return self.begin()

    def __exit__(self, *exc) -> bool:
        self.end()
        return False

    def add(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    # -- export ------------------------------------------------------------
    def to_dict(self) -> dict:
        d = {"name": self.name, "phase": self.phase,
             "duration_s": self.duration, "attrs": dict(self.attrs)}
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    def __repr__(self):
        dur = f"{self.duration:.4f}s" if self.duration is not None else "open"
        return f"Span({self.name!r}, phase={self.phase!r}, {dur})"


class Tracer:
    """Owns one run's span tree.

    ``spans`` holds the completed root spans in completion order;
    nesting is by begin/end bracketing (a span begun while another is
    open becomes its child). Not thread-safe — one tracer per session,
    like the HoistCache it instruments.
    """

    def __init__(self):
        self.spans: list[Span] = []
        self._stack: list[Span] = []

    def span(self, name: str, phase: Optional[str] = None, session=None,
             **attrs) -> Span:
        """A new (unstarted) span — enter it (``with``) or ``begin()``."""
        return Span(self, name, phase, session=session, **attrs)

    def record(self, name: str, seconds: float,
               phase: Optional[str] = None, **attrs) -> Span:
        """Append a pre-timed span (no live begin/end window) — the
        step-monitor path, where the caller measured the
        duration itself."""
        s = Span(self, name, phase, **attrs)
        s.t0 = time.perf_counter() - seconds
        s.duration = seconds
        self._close(s)
        return s

    # -- span plumbing -----------------------------------------------------
    def _open(self, span: Span) -> None:
        self._stack.append(span)

    def _close(self, span: Span) -> None:
        if self._stack and self._stack[-1] is span:
            self._stack.pop()
        parent = self._stack[-1] if self._stack else None
        if parent is not None:
            parent.children.append(span)
        else:
            self.spans.append(span)

    # -- queries -----------------------------------------------------------
    def _walk(self, spans=None):
        for s in (self.spans if spans is None else spans):
            yield s
            yield from self._walk(s.children)

    def count(self, phase: Optional[str] = None) -> int:
        return sum(1 for s in self._walk()
                   if phase is None or s.phase == phase)

    def total(self, phase: str) -> float:
        """Summed wall seconds of every span tagged ``phase`` (children
        of a same-phase parent still count — phases don't self-nest in
        the instrumented stack)."""
        return sum(s.duration or 0.0 for s in self._walk()
                   if s.phase == phase)

    # -- export ------------------------------------------------------------
    def to_dicts(self) -> list:
        return [s.to_dict() for s in self.spans]

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dicts(), indent=indent, default=str)

    def tree_lines(self, min_seconds: float = 0.0) -> list:
        """The span tree as indented text lines (the example's session
        epilogue printer)."""
        lines = []

        def walk(span: Span, depth: int):
            if span.duration is not None and span.duration < min_seconds:
                return
            dur = (f"{span.duration * 1e3:9.2f} ms"
                   if span.duration is not None else "     open")
            tag = f" [{span.phase}]" if span.phase else ""
            attrs = ", ".join(f"{k}={v}" for k, v in span.attrs.items()
                              if k in ("impl", "backend", "kernel", "method",
                                       "n", "permutations", "batch_size",
                                       "draws_ahead"))
            lines.append(f"{dur}  {'  ' * depth}{span.name}{tag}"
                         f"{'  (' + attrs + ')' if attrs else ''}")
            for c in span.children:
                walk(c, depth + 1)

        for s in self.spans:
            walk(s, 0)
        return lines


# --------------------------------------------------------------------------
# The no-op fast path + the ambient session stack
# --------------------------------------------------------------------------
class _NullSpan:
    """THE no-op span: one process-wide singleton, so the disabled path
    allocates nothing per call (pinned by tests/test_torch_obs.py)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def begin(self):
        return self

    def end(self):
        return self

    def add(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class _ProfiledSpan:
    """A span that only a recording ``torch.profiler`` sees: no session
    collects it. Same surface as ``Span``'s lifecycle."""

    __slots__ = ("name", "_ann")

    def __init__(self, name: str):
        self.name = name
        self._ann = None

    def begin(self):
        self._ann = _annotation(self.name)
        return self

    def end(self):
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            self._ann = None
        return self

    def __enter__(self):
        return self.begin()

    def __exit__(self, *exc):
        self.end()
        return False

    def add(self, **attrs):
        return self


def profiled_span(name: str):
    """The span of a call site no session collects: the shared
    ``NULL_SPAN``, or, while a profiler records, one it sees as
    ``repro_torch.<name>``."""
    return _ProfiledSpan(name) if profiling() else NULL_SPAN


class _NullObs:
    """THE no-op session: every instrumented call site talks to this when
    observability is off (or no session is ambient). Same method surface
    as ``obs.report.ObsSession``, all free; its spans reach a recording
    profiler and nothing else."""

    __slots__ = ()
    enabled = False

    def span(self, name, phase=None, **attrs):
        return profiled_span(name)

    def charge(self, op, floats, **params):
        return None

    def charge_hoist(self, artifact, n, table=None):
        return None

    def charge_perm_batch(self, op, n, permutations, batch, **params):
        return None

    def charge_production(self, n, d, block, **params):
        return None


NULL_OBS = _NullObs()

# the ambient stack: a Workspace-level span pushes its session so free
# functions deeper in the stack (stats.engine, core.pcoa, dist.driver)
# attach their spans/charges to the session that invoked them. Plain
# list, not a contextvar: the analysis stack is synchronous.
_STACK: list = []


def current_obs():
    """The innermost active session, or ``NULL_OBS`` (the free path)."""
    return _STACK[-1] if _STACK else NULL_OBS


def push_obs(session) -> None:
    _STACK.append(session)


def pop_obs(session) -> None:
    if _STACK and _STACK[-1] is session:
        _STACK.pop()
    elif session in _STACK:              # unbalanced exit: drop it anyway
        _STACK.remove(session)
