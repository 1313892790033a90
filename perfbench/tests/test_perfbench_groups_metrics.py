"""The seven metrics of the grouping cells against values worked out by
hand on a synthetic trace, and silent where a run has nothing for them."""

from pathlib import Path

import pytest

from perfbench import harness, manifest
from perfbench import spans  # noqa: F401  (the traces carry the port's spans)
from perfbench import trace as tracing

BENCH = Path(__file__).resolve().parents[1]
US = 1e-6
METRICS = ("permanova_s.study", "anosim_s.study", "permdisp_s.study",
           "hoist_s.study", "permanova_roofline", "anosim_roofline",
           "mfu.groups")


def reader(metric):
    return manifest.load_module(BENCH / "metrics" / f"{metric}.py")


def x(cat, name, lo, hi, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": lo, "dur": hi - lo}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def call(name, lo, hi):
    return x("user_annotation", tracing.SPAN_PREFIX + name, lo, hi)


def span(name, lo, hi):
    return x("user_annotation", "repro_torch." + name, lo, hi)


def kernel(corr, at, lo, hi):
    return [x("cuda_runtime", "cudaLaunchKernel", at, at + 0.5, corr=corr),
            x("kernel", f"k{corr}", lo, hi, corr=corr)]


def events():
    # window [0, 100] us, one study: session [2, 10], permanova [10, 40],
    # anosim [40, 70], permdisp [70, 95]. Hoists: gram [11, 20], its
    # kernel [12, 22] ending after it; condensed [21, 24] (begun while
    # gram's kernel ran); ranks [41, 50] holding condensed [42, 45];
    # coords [71, 80] holding operator [72, 75], its kernel [76, 82].
    # Tiles' kernels: [25, 35] (permanova), [55, 68] (anosim), [84, 90]
    # (permdisp).
    return [
        x("user_annotation", tracing.WINDOW, 0, 100),
        call("session", 2, 10), call("permanova", 10, 40),
        call("anosim", 40, 70), call("permdisp", 70, 95),
        span("hoist:gram", 11, 20), span("hoist:condensed", 21, 24),
        span("hoist:ranks", 41, 50), span("hoist:condensed", 42, 45),
        span("hoist:coords", 71, 80), span("hoist:operator", 72, 75),
        *kernel(1, 11.5, 12, 22), *kernel(2, 24, 25, 35),
        *kernel(3, 51, 55, 68), *kernel(4, 77, 76, 82),
        *kernel(5, 83, 84, 90),
    ]


def run_of(evs, least=None):
    return harness.Run(setup_s=1.0, window_s=2.0, studies=4,
                       peak_bytes=None, least=least or {},
                       trace=tracing.reduce(evs))


LEAST = {"session": {"seconds": 0.001}, "permanova": {"seconds": 0.004},
         "anosim": {"seconds": 0.004}, "permdisp": {"seconds": 0.001}}


def test_the_grouping_metrics_by_hand():
    run = run_of(events(), LEAST)
    # each call until its span or its last kernel ends
    assert reader("permanova_s.study").read(run) == pytest.approx(30 * US)
    assert reader("anosim_s.study").read(run) == pytest.approx(30 * US)
    assert reader("permdisp_s.study").read(run) == pytest.approx(25 * US)
    # [11, 24] (gram until its kernel ends, then condensed), [41, 50]
    # (condensed inside ranks), [71, 82] (operator inside coords, the
    # coordinates' kernel ending after both)
    assert reader("hoist_s.study").read(run) == pytest.approx(33 * US)
    # permanova launched [12, 22] and [25, 35]: 20 us busy for 4 ms least
    assert reader("permanova_roofline").read(run) == pytest.approx(
        100 * 0.004 / (20 * US))
    assert reader("anosim_roofline").read(run) == pytest.approx(
        100 * 0.004 / (13 * US))
    # a study's least 0.010 s over the untraced 0.5 s a study
    assert reader("mfu.groups").read(run) == pytest.approx(2.0)


def test_hoists_count_once_a_study():
    evs = events()
    evs[2] = call("permanova", 10, 30)
    evs.insert(3, call("permanova", 30, 40))
    assert run_of(evs).trace.program.studies == 2
    assert reader("hoist_s.study").read(run_of(evs)) == pytest.approx(
        33 * US / 2)


@pytest.mark.parametrize("metric", METRICS)
def test_the_grouping_metrics_stay_silent_without_their_work(metric):
    # no trace and no peak (the CPU), then a trace without the port's
    # spans or any test's call
    bare = [ev for ev in events()
            if not ev.get("name", "").startswith("repro_torch.")
            and ev.get("name") not in ("perfbench.permanova",
                                       "perfbench.anosim",
                                       "perfbench.permdisp")]
    for run in (harness.Run(1.0, 2.0, 4, None,
                            {c: None for c in LEAST}),
                run_of(bare)):
        assert reader(metric).read(run) is None
