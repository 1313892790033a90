"""The port's spans in a traced window (``perfbench/spans.py``) and the
metrics that read them, against values worked out by hand, and on a tiny
traced run of each cell on the CPU."""

import dataclasses
import json
import sys
import types
from pathlib import Path

import pytest
import torch

from perfbench import harness, manifest
from perfbench import spans as program_spans
from perfbench import trace as tracing

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
US = 1e-6
SQUARE = "square-16k.study"
FEATURES = "features-hmp-v35.core-metrics"
TINY = {SQUARE: {"n": 48}, FEATURES: {"n": 48, "d": 512}}
READERS = ("orders_s.study", "tile_idle.study", "matvec_s.study",
           "matvec_idle.study", "panel_idle.study")


def reader(metric):
    return manifest.load_module(BENCH / "metrics" / f"{metric}.py")


def x(cat, name, lo, hi, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": lo, "dur": hi - lo}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def span(name, lo, hi):
    return x("user_annotation", "repro_torch." + name, lo, hi)


def events():
    # window [0, 100] us; calls mantel [5, 60], pcoa [62, 98]; inside them
    # engine.mantel [6, 58] holding engine.orders [7, 20] and two tiles
    # [22, 35], [36, 50]; pcoa.fsvd [63, 97] holding two matvecs [64, 70],
    # [80, 90]. A copy [19, 24] launched at 18 (orders, ending after its
    # span); kernels [25, 30] at 23 and [38, 45] at 37 (the tiles), [66,
    # 72] at 65 and [83, 86] at 82 (the matvecs), [91, 92] with no launch
    # in the trace (pcoa.fsvd by its start). The device's copy of a tile
    # span over the whole window is not read.
    return [
        x("user_annotation", "perfbench.window", 0, 100),
        x("user_annotation", "perfbench.mantel", 5, 60),
        x("user_annotation", "perfbench.pcoa", 62, 98),
        span("engine.mantel", 6, 58),
        span("engine.orders", 7, 20),
        span("engine.tile", 22, 35),
        span("engine.tile", 36, 50),
        span("pcoa.fsvd", 63, 97),
        span("operator.matvec", 64, 70),
        span("operator.matvec", 80, 90),
        x("gpu_user_annotation", "repro_torch.engine.tile", 0, 100),
        x("cuda_runtime", "cudaMemcpyAsync", 18, 19, corr=1),
        x("cuda_runtime", "cudaLaunchKernel", 23, 24, corr=2),
        x("cuda_runtime", "cudaLaunchKernel", 37, 38, corr=3),
        x("cuda_runtime", "cudaLaunchKernel", 65, 66, corr=4),
        x("cuda_runtime", "cudaLaunchKernel", 82, 83, corr=5),
        x("gpu_memcpy", "Memcpy HtoD", 19, 24, corr=1),
        x("kernel", "partials", 25, 30, corr=2),
        x("kernel", "partials", 38, 45, corr=3),
        x("kernel", "center_matvec", 66, 72, corr=4),
        x("kernel", "center_matvec", 83, 86, corr=5),
        x("kernel", "geqrf", 91, 92, corr=9),
        x("cpu_op", "aten::randint", 8, 17),
        {"ph": "f", "name": "flow"},
    ]


def test_program_spans_by_hand():
    t = tracing.reduce(events())
    p = t.program
    assert t.busy_s == pytest.approx(27 * US)
    assert {name: p.count(name) for name in p.spans} == {
        "engine.mantel": 1, "engine.orders": 1, "engine.tile": 2,
        "pcoa.fsvd": 1, "operator.matvec": 2}
    assert p.studies == 1 and p.window_s == pytest.approx(100 * US)
    # nested spans hold their children's work: the engine all three
    assert [len(w) for w in p.work["engine.mantel"]] == [3]
    assert p.work["engine.tile"] == [[(25 * US, 30 * US)],
                                     [(38 * US, 45 * US)]]
    assert [len(w) for w in p.work["pcoa.fsvd"]] == [3]
    # orders until its copy ends at 24; tiles 13 + 14; matvecs 8 + 10
    assert p.seconds("engine.orders") == pytest.approx(17 * US)
    assert p.seconds("engine.tile") == pytest.approx(27 * US)
    assert p.seconds("operator.matvec") == pytest.approx(18 * US)
    assert p.seconds("engine.mantel") == pytest.approx(52 * US)
    # gaps [0, 19] (no span open), [24, 25] and [30, 38] (tile 1), [45,
    # 66] (tile 2), [72, 83] (pcoa.fsvd: matvec 1 closed at 70), [86, 91]
    # (matvec 2), [92, 100] (pcoa.fsvd)
    assert p.idle == pytest.approx({"engine.tile": 30 * US,
                                    "pcoa.fsvd": 19 * US,
                                    "operator.matvec": 5 * US})
    # 54 of the window's 73 idle us began inside some span
    assert t.window_s - t.busy_s == pytest.approx(73 * US)
    assert sum(p.idle.values()) == pytest.approx(54 * US)


def test_the_wrapped_reduction_leaves_the_trace_as_it_was():
    wrapped = tracing.reduce(events())
    base = tracing.reduce.__wrapped__(events())
    assert not hasattr(base, "program")
    assert dataclasses.astuple(wrapped) == dataclasses.astuple(base)
    program_spans.install()             # once a process
    assert tracing.reduce.__wrapped__ is not tracing.reduce
    assert not hasattr(tracing.reduce.__wrapped__, "__wrapped__")


def test_read_carries_the_program_spans(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events()}))
    assert tracing.read(path).program.count("engine.tile") == 2


def test_innermost_takes_the_deepest_open_span():
    nested = [(0, 10, "a"), (1, 5, "b"), (2, 3, "c"), (6, 8, "d")]
    assert program_spans.innermost(nested, [0, 1.5, 2, 3, 5.5, 7, 9, 10]) \
        == ["a", "b", "c", "b", "a", "d", "a", None]
    assert program_spans.innermost([], [1.0]) == [None]


def run_of(evs, studies=4):
    return harness.Run(setup_s=1.0, window_s=8.0, studies=studies,
                       peak_bytes=None, least={},
                       trace=tracing.reduce(evs))


def test_program_readers_from_a_trace():
    # two studies: a second mantel call span, with its own draw whose
    # copy ends within it
    evs = events()
    evs[1] = x("user_annotation", "perfbench.mantel", 5, 30)
    evs.insert(2, x("user_annotation", "perfbench.mantel", 31, 60))
    run = run_of(evs)
    assert run.trace.program.studies == 2
    assert reader("orders_s.study").read(run) == pytest.approx(17 * US / 2)
    assert reader("matvec_s.study").read(run) == pytest.approx(18 * US / 2)
    assert reader("tile_idle.study").read(run) == pytest.approx(30.0)
    assert reader("matvec_idle.study").read(run) == pytest.approx(5.0)
    # spans absent: nothing to read
    assert reader("panel_idle.study").read(run) is None


def test_program_readers_stay_silent_without_spans():
    bare = [ev for ev in events() if not ev.get("name", "").startswith(
        "repro_torch.")]
    for run in (run_of(bare), harness.Run(1.0, 8.0, 4, None, {})):
        for metric in READERS:
            assert reader(metric).read(run) is None, metric


def test_library_seconds_read_the_ports_counter(monkeypatch):
    run = harness.Run(1.0, 8.0, 4, None, {})
    name = "repro_torch.kernels._build"
    for module, want in ((types.SimpleNamespace(load_seconds=4.25), 4.25),
                         (types.SimpleNamespace(load_seconds=0.0), None),
                         (types.SimpleNamespace(), None)):
        monkeypatch.setitem(sys.modules, name, module)
        assert reader("library_s").read(run) == want
    monkeypatch.delitem(sys.modules, name)
    assert reader("library_s").read(run) is None


@pytest.mark.parametrize("workload,want", [
    (SQUARE, {"engine.orders": 1, "engine.tile": 32, "operator.matvec": 4}),
    (FEATURES, {"dist.panel": 1, "operator.matvec": 4})])
def test_a_tiny_traced_window_counts_the_ports_spans(workload, want):
    """Each study of the CPU's traced window: one draw and 32 tiles of
    K = 999 (square), one panel of 48 rows (features), four products."""
    cell = manifest.resolve(manifest.load_json(ROOT / "BENCHMARK.json"),
                            workload)
    device = torch.device("cpu")
    bench = harness.Bench(cell, 2**31 + 17, device, TINY[workload])
    with harness.profiled(device) as prof:
        with torch.profiler.record_function(tracing.WINDOW):
            studies, failed, _ = bench.window(0.0, count=2)
    trace = harness.read_trace(prof)
    program = trace.program
    assert not failed and program.studies == 2
    assert {name: program.count(name) / 2 for name in want} == want
    run = harness.Run(1.0, 1.0, 2, None, {}, trace)
    metrics = {m["name"] for m in cell.per_layer}
    for metric in READERS:
        if metric in metrics:
            assert reader(metric).read(run) is not None, metric
