"""The reduction of a profiler trace, against values worked out by hand."""

import json

import pytest

from perfbench import trace as tracing

US = 1e-6


def x(cat, name, lo, hi, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": lo, "dur": hi - lo}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def events():
    # window [0, 100] us; spans mantel [5, 50], pcoa [55, 95]; kernels
    # [10, 30] and [20, 40] launched at 8 and 9 (mantel), a copy [60, 70]
    # launched at 45 (mantel, run after its span), a kernel [80, 85] with
    # no launch in the trace (pcoa by its start); host ops randint [35, 58]
    # (with a nested op) and matmul [72, 80]
    return [
        x("user_annotation", "perfbench.window", 0, 100),
        x("user_annotation", "perfbench.mantel", 5, 50),
        x("user_annotation", "perfbench.pcoa", 55, 95),
        x("cuda_runtime", "cudaLaunchKernel", 8, 9, corr=1),
        x("cuda_runtime", "cudaLaunchKernelExC", 9, 10, corr=2),
        x("cuda_runtime", "cudaMemcpyAsync", 45, 46, corr=3),
        x("kernel", "partials", 10, 30, corr=1),
        x("kernel", "partials", 20, 40, corr=2),
        x("gpu_memcpy", "Memcpy HtoD", 60, 70, corr=3),
        x("kernel", "matvec", 80, 85, corr=9),
        x("cpu_op", "aten::randint", 35, 58),
        x("cpu_op", "aten::random_", 36, 57),
        x("cpu_op", "aten::matmul", 72, 80),
        {"ph": "f", "name": "flow"},
    ]


def test_merge_covered_and_gaps():
    merged = tracing.merge([(10, 30), (20, 40), (60, 70), (40, 45)])
    assert merged == [(10, 45), (60, 70)]
    assert tracing.covered(merged, 0, 100) == 45
    assert tracing.covered(merged, 25, 65) == 25
    assert tracing.gaps(merged, 0, 100) == [(0, 10), (45, 15), (70, 30)]
    assert tracing.gaps([], 3, 4) == [(3, 1)]


def test_reduce_by_hand():
    t = tracing.reduce(events())
    assert t.window_s == pytest.approx(100 * US)
    assert t.busy_s == pytest.approx(45 * US)
    assert t.calls("mantel") == t.calls("pcoa") == 1
    assert t.calls("validate") == 0
    # mantel launched [10, 40] and the copy [60, 70]; pcoa ran [80, 85]
    assert t.busy_in("mantel") == pytest.approx(40 * US)
    assert t.busy_in("pcoa") == pytest.approx(5 * US)
    assert t.busy_in("validate") == 0
    # mantel lasts from 5 until its copy ends at 70; pcoa its span
    assert t.seconds("mantel") == pytest.approx(65 * US)
    assert t.seconds("pcoa") == pytest.approx(40 * US)
    ops = dict((k, v) for k, v in t.device_ops)
    assert ops["partials"] == pytest.approx(40 * US)
    assert ops["Memcpy HtoD"] == pytest.approx(10 * US)
    gaps = dict((k, v) for k, v in t.idle_gaps)
    # [0, 10]: no span open; [40, 60]: mantel until 50 with randint open
    # at 40; [70, 80] and [85, 100]: pcoa, no host op open at 70 or 85
    assert gaps == pytest.approx({"harness": 10 * US,
                                  "mantel/aten::randint": 20 * US,
                                  "pcoa": 25 * US})
    assert t.idle_gaps[0][0] == "pcoa"


def test_read_takes_a_chrome_trace_file(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events()}))
    assert tracing.read(path).busy_s == pytest.approx(45 * US)


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        tracing.reduce([x("kernel", "k", 0, 1)])
