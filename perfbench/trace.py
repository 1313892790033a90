"""Reduce a ``torch.profiler`` trace to what the per-layer metrics read.

The traced run records, with ``torch.profiler.record_function``, one span
``perfbench.window`` around the measured window and one ``perfbench.<call>``
around every call into the port; nothing synchronises inside a study. From
the exported Chrome trace this module takes, in seconds:

* the device's busy intervals: the union of every kernel, memcpy and memset
  interval, whatever stream ran it;
* each call's device work: the device operations whose launch (the runtime
  call with the same correlation id) lies inside one of its spans, or, for
  an operation with no launch in the trace, whose start does;
* each call's seconds: from its span's start until the span ends or its
  last device operation does, whichever is later;
* the ten device operations that took most time, by name;
* the idle gaps of the device inside the window, each named by the
  benchmark span and the outermost host operation open when it began, and
  summed by that name.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "perfbench."
WINDOW = SPAN_PREFIX + "window"
TOP = 10
#: longest name kept in a breakdown entry
NAME_CHARS = 96


def merge(intervals) -> list:
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1][1] = hi
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def covered(merged, lo: float, hi: float, starts=None) -> float:
    """Length of ``[lo, hi]`` that the merged intervals cover (``starts``:
    their start times, when the caller keeps them)."""
    if starts is None:
        starts = [a for a, _ in merged]
    total = 0.0
    first = max(bisect.bisect_right(starts, lo) - 1, 0)
    for a, b in merged[first:]:
        if a >= hi:
            break
        total += max(0.0, min(b, hi) - max(a, lo))
    return total


def gaps(merged, lo: float, hi: float) -> list:
    """The ``(start, length)`` stretches of ``[lo, hi]`` none covers."""
    out, at = [], lo
    for a, b in merged:
        if b <= lo:
            continue
        if a >= hi:
            break
        if a > at:
            out.append((at, a - at))
        at = max(at, b)
    if at < hi:
        out.append((at, hi - at))
    return out


def outermost(events) -> list:
    """The ``(start, end, name)`` events not inside an earlier one."""
    out = []
    for lo, hi, name in sorted(events):
        if out and lo < out[-1][1]:
            continue
        out.append((lo, hi, name))
    return out


def open_at(events, starts, t: float):
    """Name of the event of ``events`` (outermost, sorted) open at ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and events[i][0] <= t < events[i][1]:
        return events[i][2]
    return None


@dataclasses.dataclass
class Trace:
    window: tuple
    busy: list
    spans: dict
    work: dict
    device_ops: list
    idle_gaps: list

    def __post_init__(self):
        self.starts = [a for a, _ in self.busy]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return covered(self.busy, *self.window, self.starts)

    def calls(self, call: str) -> int:
        return len(self.spans.get(call, ()))

    def busy_in(self, call: str) -> float:
        """Device-busy seconds of the work the spans of ``call`` launched."""
        return sum(b - a for a, b in merge(
            iv for ivs in self.work.get(call, ()) for iv in ivs))

    def seconds(self, call: str) -> float:
        """Seconds of the calls of ``call``, each until its span or its
        last device operation ends."""
        total = 0.0
        for (lo, hi), ivs in zip(self.spans.get(call, ()),
                                 self.work.get(call, ())):
            total += max([hi] + [b for _, b in ivs]) - lo
        return total


def reduce(events: list) -> Trace:
    """A ``Trace`` from Chrome trace events (``ts``/``dur`` in us)."""
    device, spans, host_ops, launched = [], defaultdict(list), [], {}
    window = None
    op_time = defaultdict(float)
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        lo = float(ev["ts"]) * 1e-6
        hi = lo + float(ev["dur"]) * 1e-6
        cat, name = ev.get("cat", ""), ev.get("name", "")
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATEGORIES:
            device.append((lo, hi, corr))
            op_time[name[:NAME_CHARS]] += hi - lo
        elif cat in LAUNCH_CATEGORIES and corr is not None:
            launched[corr] = lo
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            if name == WINDOW:
                window = (lo, hi)
            else:
                spans[name[len(SPAN_PREFIX):]].append((lo, hi))
        elif cat == "cpu_op":
            host_ops.append((lo, hi, name))
    if window is None:
        raise ValueError(f"the trace holds no {WINDOW!r} span")
    for ivs in spans.values():
        ivs.sort()
    busy = merge((lo, hi) for lo, hi, _ in device)
    named = outermost((lo, hi, (call, i)) for call, ivs in spans.items()
                      for i, (lo, hi) in enumerate(ivs))
    named_starts = [e[0] for e in named]
    work = {call: [[] for _ in ivs] for call, ivs in spans.items()}
    for lo, hi, corr in device:
        owner = open_at(named, named_starts, launched.get(corr, lo))
        if owner is not None:
            work[owner[0]][owner[1]].append((lo, hi))
    ops = outermost(host_ops)
    op_starts = [e[0] for e in ops]
    idle = defaultdict(float)
    for start, length in gaps(busy, *window):
        owner = open_at(named, named_starts, start)
        span = owner[0] if owner else "harness"
        op = open_at(ops, op_starts, start)
        idle[f"{span}/{op}" if op else span] += length
    top_ops = sorted(op_time.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return Trace(window, busy, dict(spans), work,
                 [list(kv) for kv in top_ops], [list(kv) for kv in top_gaps])


def read(path: Path) -> Trace:
    data = json.loads(Path(path).read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    return reduce(events)
