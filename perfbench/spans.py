"""The port's own spans in a traced window, for the metrics that read them.

While a ``torch.profiler`` records, every span of the port opens
``torch.profiler.record_function("repro_torch.<name>")``, so the exported
Chrome trace holds the spans as ``user_annotation`` events beside the
device's operations, on one clock. ``gpu_user_annotation`` events, their
copies on the device's timeline, are not read, and device busy stays what
``perfbench.trace`` makes it: kernels, memcpys and memsets. From the trace
this module takes, in seconds:

* each program span name's intervals (spans of one name do not overlap);
* each span's device work: the device operations whose launch (by
  correlation id) or, without one in the trace, whose start lies inside
  it, through its nested spans too;
* the idle seconds of the window by the innermost program span open when
  each gap began; a gap that began with none open is nobody's;
* the traced window's studies: the calls of the most called
  ``perfbench.<call>`` span, as each study calls each of its calls once.

``perfbench.trace.reduce`` keeps only the benchmark's own spans. Importing
this module wraps it so that the ``Trace`` it returns also carries this
reduction as ``trace.program``, every other field as it was. The metric
readers that need it import this module, and the harness loads every
reader of a cell before its run, so the wrapper is in place before the
window is traced. A trace without the port's spans (a program that opens
none) gives an empty reduction, and those readers then give None.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
from collections import defaultdict
from typing import Optional

from perfbench import trace as tracing

PREFIX = "repro_torch."


@dataclasses.dataclass
class Program:
    spans: dict
    work: dict
    idle: dict
    window_s: float
    studies: int

    def count(self, name: str) -> int:
        return len(self.spans.get(name, ()))

    def seconds(self, name: str) -> float:
        """Seconds of the spans of ``name``, each until it or the last
        device operation launched inside it ends."""
        return sum(max([hi] + [b for _, b in ivs]) - lo
                   for (lo, hi), ivs in zip(self.spans.get(name, ()),
                                            self.work.get(name, ())))


def innermost(spans: list, times: list) -> list:
    """For each of the sorted ``times``, the name of the innermost of the
    nested ``(start, end, name)`` spans open then, or None."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def reduce(events: list, trace: tracing.Trace) -> Program:
    """The program's spans of Chrome trace ``events`` (``ts``/``dur`` in
    us), against ``trace``, the same events' ``perfbench.trace`` view."""
    spans, device, launched = defaultdict(list), [], {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        lo = float(ev["ts"]) * 1e-6
        hi = lo + float(ev["dur"]) * 1e-6
        cat, name = ev.get("cat", ""), ev.get("name", "")
        corr = (ev.get("args") or {}).get("correlation")
        if cat in tracing.DEVICE_CATEGORIES:
            device.append((lo, hi, corr))
        elif cat in tracing.LAUNCH_CATEGORIES and corr is not None:
            launched[corr] = lo
        elif cat == "user_annotation" and name.startswith(PREFIX):
            spans[name[len(PREFIX):]].append((lo, hi))
    for ivs in spans.values():
        ivs.sort()
    work = {name: [[] for _ in ivs] for name, ivs in spans.items()}
    starts = {name: [lo for lo, _ in ivs] for name, ivs in spans.items()}
    for lo, hi, corr in device:
        at = launched.get(corr, lo)
        for name, ivs in spans.items():
            i = bisect.bisect_right(starts[name], at) - 1
            if i >= 0 and at < ivs[i][1]:
                work[name][i].append((lo, hi))
    idle = defaultdict(float)
    gaps = tracing.gaps(trace.busy, *trace.window)
    owners = innermost([(lo, hi, name) for name, ivs in spans.items()
                        for lo, hi in ivs], [start for start, _ in gaps])
    for (_, length), owner in zip(gaps, owners):
        if owner is not None:
            idle[owner] += length
    studies = max((len(ivs) for ivs in trace.spans.values()), default=0)
    return Program(dict(spans), work, dict(idle), trace.window_s, studies)


def install() -> None:
    """Make ``perfbench.trace.reduce`` attach ``reduce``'s view to each
    ``Trace`` it returns, as ``trace.program``; once a process."""
    if getattr(tracing.reduce, "keeps_program_spans", False):
        return
    base = tracing.reduce

    @functools.wraps(base)
    def reduce_with_program(events: list) -> tracing.Trace:
        out = base(events)
        out.program = reduce(events, out)
        return out

    reduce_with_program.keeps_program_spans = True
    tracing.reduce = reduce_with_program


def of(run) -> Optional[Program]:
    """The run's program-span view; None without a traced window."""
    return getattr(run.trace, "program", None)


def study_seconds(run, name: str) -> Optional[float]:
    """Seconds of the spans of ``name`` a study of the traced window, each
    until it or its last device operation ends; None without them."""
    program = of(run)
    if program is None or not program.count(name) or not program.studies:
        return None
    return program.seconds(name) / program.studies


def idle_share(run, name: str) -> Optional[float]:
    """The traced window's idle time whose gap began with ``name`` the
    innermost open span, in percent of the window; None without them."""
    program = of(run)
    if program is None or not program.count(name) or not program.window_s:
        return None
    return 100.0 * program.idle.get(name, 0.0) / program.window_s


install()
