"""One run of one cell: set-up, the measured window, the check, the line.

The run is driven by the names in ``BENCHMARK.json`` (``perfbench.manifest``):
the cell's configuration makes its inputs on the device from the seed, its
traffic says which calls into the port make one study, and a closed loop of
one client sends studies back to back for the window's seconds.

* **Set-up** (``setup_s``): from the process's start until the window opens:
  imports, the inputs, the port's built library (built on the first run in
  a checkout, into ``build/`` inside it), one warm-up study of the cell's
  own shapes with its own key.
* **Window**: studies until ``seconds`` have passed; the last one started
  runs to its end and the window with it. Each call runs inside a
  ``perfbench.<call>`` profiler span and each study ends in one
  synchronisation; nothing else synchronises. ``--trace 1`` first runs such
  a window untraced, whose seconds a study the whole-study metrics read,
  then a second one under ``torch.profiler``, which the per-layer metrics
  read (``perfbench.trace``).
* **Outputs kept**: every study's, except where the call's entry has a
  ``summary``: then every study but the window's last keeps only that, cut
  before the next study starts, so the check holds no memory that a
  deployment would not.
* **Check**: once the window has closed, its peak memory has been read and
  the studies' state is freed, each call's reference judges what the
  window kept (``perfbench/reference/``), each reading against its limit in
  ``limits/<workload>.json``.

Metrics are read by ``metrics/<name>.py`` from a ``Run``: the cell's
``end_to_end`` metrics with ``--trace 0``, its ``per_layer`` metrics with
``--trace 1``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from perfbench import manifest, roofline, traffic
from perfbench import trace as tracing

#: top-level modules that may not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
EXIT_NO_DEVICE = 2
EXIT_FORBIDDEN = 3


class CannotRun(RuntimeError):
    """The machine or the checkout lacks what the cell needs."""


@dataclasses.dataclass
class Study:
    key: int
    outputs: dict


@dataclasses.dataclass
class Run:
    """What a run measured, as the metric readers see it: ``window_s`` and
    ``studies`` of the untraced window, ``trace`` of the traced one."""

    setup_s: float
    window_s: float
    studies: int
    peak_bytes: Optional[int]
    least: dict
    trace: Optional[tracing.Trace] = None

    @property
    def busy_s(self) -> Optional[float]:
        """Device-busy seconds of the traced window; None without any."""
        busy = self.trace.busy_s if self.trace is not None else 0.0
        return busy or None

    @property
    def busy_window_s(self) -> Optional[float]:
        return self.trace.window_s if self.trace is not None else None

    def least_s(self, call: str) -> Optional[float]:
        least = self.least.get(call)
        return None if least is None else least["seconds"]

    @property
    def least_study_s(self) -> Optional[float]:
        """The least time of one study's calls; None without a peak."""
        if not self.least or any(v is None for v in self.least.values()):
            return None
        return sum(self.least_s(c) for c in self.least)

    def call_s(self, call: str) -> Optional[float]:
        """Seconds of one call of ``call`` in the traced window, until its
        device work ended; None where it made none."""
        if self.trace is None or not self.trace.calls(call):
            return None
        return self.trace.seconds(call) / self.trace.calls(call)

    def roofline(self, call: str) -> Optional[float]:
        """The calls' least time over the device-busy time of the work
        they launched, in percent; None where either is missing."""
        least = self.least_s(call)
        if least is None or self.trace is None:
            return None
        busy = self.trace.busy_in(call)
        return 100.0 * least * self.trace.calls(call) / busy if busy \
            else None


def forbidden_modules(names=None) -> list:
    """The top-level names of ``FORBIDDEN`` among ``names`` (by default
    the modules loaded), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def check_device(chips: int) -> None:
    if not torch.cuda.is_available():
        raise CannotRun("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise CannotRun(f"the cell asks for {chips} CUDA devices, "
                       f"{torch.cuda.device_count()} present")
    if importlib.util.find_spec("repro_torch") is None:
        raise CannotRun("the port (src/repro_torch) is not in this checkout")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Bench:
    """One cell's inputs, plan and work counts, made from one seed."""

    def __init__(self, cell: manifest.Cell, seed: int, device: torch.device,
                 overrides: Optional[dict] = None):
        self.cell = cell
        self.device = device
        self.config = {**cell.config, **(overrides or {})}
        self.plan = traffic.Plan(cell.traffic, seed)
        self.inputs = cell.inputs().make(self.config, self.plan, device)
        self.entries = {c.name: cell.entry(c) for c in cell.calls}
        peak = (roofline.peak_for(torch.cuda.get_device_name(device))
                if device.type == "cuda" else None)
        self.least = {c.name: roofline.least(
            cell.work(c).count(self.inputs, c.args), peak)
            for c in cell.calls}

    def study(self, key: int) -> dict:
        """One study's calls, each in a profiler span, synchronised once at
        its end."""
        state, outputs = {}, {}
        for call in self.cell.calls:
            with torch.profiler.record_function(
                    tracing.SPAN_PREFIX + call.name):
                outputs[call.name] = self.entries[call.name].call(
                    self.inputs, call.args, key, self.device, state)
        sync(self.device)
        return outputs

    def summarise(self, study: Study) -> None:
        """Cut ``study``'s outputs to what its entries' ``summary`` keep."""
        for name, out in study.outputs.items():
            summary = getattr(self.entries[name], "summary", None)
            if summary is not None and out is not None:
                study.outputs[name] = summary(out)

    def window(self, seconds: float, first: int = 0,
               count: Optional[int] = None):
        """Closed-loop studies for ``seconds`` (or ``count`` studies),
        numbered from ``first``: ``(studies, failed, seconds)``, each study
        its key and kept outputs."""
        studies, failed, ends = [], 0, []
        t0 = time.perf_counter()
        index = first
        while True:
            if studies:
                self.summarise(studies[-1])
            key = self.plan.key(index)
            try:
                studies.append(Study(key, self.study(key)))
            except Exception:       # a study that fails is counted, not fatal
                if not failed:
                    traceback.print_exc()
                failed += 1
            index += 1
            ends.append(time.perf_counter() - t0)
            if (len(ends) >= count) if count is not None \
                    else ends[-1] >= seconds:
                each = sorted(b - a for a, b in zip([0.0] + ends, ends))
                print(f"studies {len(each)}: min {each[0]:.4f} s, median "
                      f"{each[len(each) // 2]:.4f} s, max {each[-1]:.4f} s",
                      file=sys.stderr)
                return studies, failed, ends[-1]

    def judge_calls(self, studies: list, control: bool = False) -> dict:
        """Each judged call's readings of what the window kept; with
        ``control``, that call's reference one precision below fp32 in the
        program's place."""
        readings = {}
        for call in self.cell.calls:
            ref = self.cell.reference(call)
            if ref is not None:
                readings[call.name] = ref.judge(
                    call.name, self.inputs, call.args, studies,
                    self.plan.rng(call.name), self.cell.limits, control)
        return readings

    def judge(self, studies: list, control: bool = False) -> dict:
        """Every call's readings in one dict."""
        return {name: value for readings in
                self.judge_calls(studies, control).values()
                for name, value in readings.items()}


def profiled(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def read_trace(prof) -> tracing.Trace:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return tracing.read(Path(path))
    finally:
        os.unlink(path)


def compare(readings: dict, limits: dict) -> dict:
    checks = {}
    for name, value in readings.items():
        if value is None:
            continue
        if name not in limits:
            raise manifest.ManifestError(f"reading {name!r} has no limit")
        checks[name] = {"value": value, "limit": limits[name]}
    return checks


def passed(check: dict) -> bool:
    return check["value"] <= check["limit"]


def metrics_of(cell: manifest.Cell, run: Run, trace: bool) -> dict:
    out = {}
    for metric in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(metric["name"]).read(run)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             overrides: Optional[dict] = None,
             started: Optional[float] = None) -> dict:
    """One run of ``workload``: its result line as a dict. ``device="cpu"``
    drives the port's plain versions (the tests); only ``main`` looks for
    a card."""
    started = time.perf_counter() if started is None else started
    marks = [("imports", time.perf_counter())]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    cell = manifest.resolve(manifest.load_json(root / "BENCHMARK.json"),
                            workload, root / "perfbench")
    bench = Bench(cell, seed, dev, overrides)
    sync(dev)
    marks.append(("inputs", time.perf_counter()))
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.library()
    marks.append(("library", time.perf_counter()))
    bench.study(bench.plan.warmup_key)
    sync(dev)
    marks.append(("warm-up", time.perf_counter()))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - started
    print("setup " + ", ".join(
        f"{name} {t - prev:.3f} s" for (name, t), prev in
        zip(marks, [started] + [t for _, t in marks])), file=sys.stderr)

    studies, failed, window_s = bench.window(seconds)
    timed = len(studies)
    trace_view = None
    if trace:
        if studies:
            bench.summarise(studies[-1])
        with profiled(dev) as prof:
            with torch.profiler.record_function(tracing.WINDOW):
                traced, traced_failed, traced_s = bench.window(
                    seconds, first=len(studies) + failed)
        trace_view = read_trace(prof)
        if timed and traced:
            print(f"traced / untraced seconds a study: "
                  f"{(traced_s / len(traced)) / (window_s / timed):.4f}",
                  file=sys.stderr)
        studies, failed = studies + traced, failed + traced_failed
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    run = Run(setup_s, window_s, timed, peak, bench.least, trace_view)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    checks = compare(bench.judge(studies), cell.limits)
    print(f"judged in {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    correct = not failed and bool(studies) and \
        all(passed(c) for c in checks.values())
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": int(cell.workload["chips"]),
        "memory_peak_bytes": int(peak or 0)}
    result = {"correct": correct, "attempted": len(studies) + failed,
              "failed": failed, "metrics": metrics_of(cell, run, trace),
              "device": device_info}
    if trace_view is not None:
        device_info["busy_s"] = trace_view.busy_s
        device_info["window_s"] = trace_view.window_s
        result["breakdown"] = {"device_ops": trace_view.device_ops,
                               "idle_gaps": trace_view.idle_gaps}
    result["checks"] = checks
    return result


def report_checks(checks: dict) -> None:
    for name, c in checks.items():
        verdict = "ok" if passed(c) else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)


def finite(value):
    """JSON has no inf or nan: a reading that is either prints as a
    string, and still fails its limit."""
    if isinstance(value, float) and not math.isfinite(value):
        return str(value)
    if isinstance(value, dict):
        return {k: finite(v) for k, v in value.items()}
    if isinstance(value, list):
        return [finite(v) for v in value]
    return value


def main(root: Path, args, started: float) -> int:
    cells = {w["name"]: w for w in
             manifest.load_json(root / "BENCHMARK.json")["workloads"]}
    chips = int(cells[args.workload]["chips"]) if args.workload in cells \
        else 1
    try:
        check_device(chips)
    except CannotRun as err:
        print(f"perfbench: {err}", file=sys.stderr)
        return EXIT_NO_DEVICE
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", started=started)
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded once the window closed: {found}",
              file=sys.stderr)
        return EXIT_FORBIDDEN
    report_checks(result["checks"])
    print(json.dumps(finite(result)), flush=True)
    return 0
