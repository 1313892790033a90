"""Call sentinel: count calls and specializations per entry point, live.

The counterpart of ``repro/obs/compile.py``. The reference counts jit
traces: a ``note_trace(name, signature)`` inside a jitted body runs once
per trace, and the distinct signatures are the compiled programs. The
port has no jit. Its instrumented entry points (each ``kernels/*_ops.py``
wrapper, the engine's loop functions, the production's panel step) note
every call instead, under the reference's names, with a signature of
what specializes the call: shapes, dtype, device type, and for
``permute_reduce`` S and B. So here

* ``traces``   — calls of the entry point;
* ``programs`` — distinct signatures: how many specializations ran. The
  reference's invariant "one padded tile of B serves any K" reads the
  same way: two runs of different K through the engine add calls but
  one ``kernels.permute_reduce`` signature.

This works on the CPU as on the card. The sentinel is process-global;
scope assertions with ``snapshot()``/``since()`` or the ``expect()``
context manager.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import Optional


class RecompileError(RuntimeError):
    """An entry point ran more distinct signatures than its budget."""


class CompileSentinel:
    """Per-entry-point trace and program counters."""

    def __init__(self):
        self._traces: Counter = Counter()
        self._signatures: dict = {}          # name -> set of signatures
        self._suspended = 0

    # -- recording ---------------------------------------------------------
    def note(self, name: str, signature=None) -> None:
        """Record one call of ``name``. ``signature`` is any hashable
        tuple of what specializes the call (shapes, dtype, device type);
        ``None`` degrades to call counting only."""
        if self._suspended:
            return
        self._traces[name] += 1
        if signature is not None:
            self._signatures.setdefault(name, set()).add(signature)

    # -- queries -----------------------------------------------------------
    def traces(self, name: str) -> int:
        return self._traces[name]

    def programs(self, name: str) -> int:
        return len(self._signatures.get(name, ()))

    def names(self):
        return sorted(set(self._traces) | set(self._signatures))

    def snapshot(self) -> dict:
        """{entry point: {"traces", "programs"}} — embed in a RunReport
        or diff later with ``since()``."""
        return {n: {"traces": self.traces(n), "programs": self.programs(n)}
                for n in self.names()}

    def since(self, snap: dict) -> dict:
        """Counter deltas vs an earlier ``snapshot()`` (entries with no
        new traces are omitted)."""
        out = {}
        for n in self.names():
            base = snap.get(n, {"traces": 0, "programs": 0})
            dt = self.traces(n) - base["traces"]
            dp = self.programs(n) - base["programs"]
            if dt or dp:
                out[n] = {"traces": dt, "programs": dp}
        return out

    @contextlib.contextmanager
    def suspended(self):
        """Calls inside the block are not noted: a measurement
        (``obs.probe``) runs the entry points without counting as a call
        of the session it measures."""
        self._suspended += 1
        try:
            yield self
        finally:
            self._suspended -= 1

    # -- guards ------------------------------------------------------------
    @contextlib.contextmanager
    def expect(self, name: str, max_programs: int = 1,
               max_traces: Optional[int] = None):
        """Assert at runtime that the enclosed block runs ``name`` with
        at most ``max_programs`` distinct signatures (the "one program serves
        any K" invariant: run two different K values inside the window
        and the padded path must not add a second program)."""
        base = self.snapshot()
        yield self
        delta = self.since(base).get(name, {"traces": 0, "programs": 0})
        if delta["programs"] > max_programs:
            raise RecompileError(
                f"{name}: {delta['programs']} distinct programs traced "
                f"in this window (budget: {max_programs}) — a shape or "
                f"static argument is leaking into the trace signature")
        if max_traces is not None and delta["traces"] > max_traces:
            raise RecompileError(
                f"{name}: {delta['traces']} traces in this window "
                f"(budget: {max_traces})")


#: THE process-global sentinel. Sessions embed ``snapshot()`` deltas in
#: their reports.
sentinel = CompileSentinel()


def note_trace(name: str, signature=None) -> None:
    """Module-level shorthand the instrumented entry points call."""
    sentinel.note(name, signature)
