"""Port parity of the observability layer: ``repro_torch.obs`` against
``repro.obs``.

The cases of ``tests/test_obs.py``: span tracer semantics and exports,
the analytic registry re-deriving the committed ratios (10.97x and 16.45x
for the Mantel loop, 11 against 16 n²-passes for a session), the call
sentinel's one-program-per-shape guarantee across K values, and a
RunReport from an instrumented battery, square- and feature-backed, whose
ledger and cache sections equal the reference's after the same calls.
Left out: ``test_registry_parity_benchmarks_import_the_registry`` (it
checks the reference's benchmark modules, which are not ported). A
report's ``measured`` and ``drift`` sections are checked for the entry
points and verdicts the session runs; the probes themselves are tested,
against the reference, in ``tests/test_torch_probe.py``.
"""

import json
import time
from collections import Counter

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
import repro.obs as jax_obs
import repro.obs.compile
import repro.obs.report
from repro.api import ExecConfig as JaxExecConfig
from repro.api import Workspace as JaxWorkspace
from repro.stats.engine import permutation_orders as jax_orders
from repro_torch.api import ExecConfig, Workspace
from repro_torch.core import random_distance_matrix
from repro_torch.core.pcoa import sketch_width
from repro_torch.obs import (FEATURE_HOIST_PASSES, HOIST_PASSES, NULL_OBS,
                             NULL_SPAN, CompileSentinel, Ledger, ObsConfig,
                             RecompileError, RunReport, Tracer, build_report,
                             current_obs, perm_traffic_floats,
                             production_floats, sentinel)

KEY = jax.random.PRNGKey(7)
OBS = ObsConfig(enabled=True)


def _features(seed, n=40, d=8):
    rng = np.random.default_rng(seed)
    return (rng.random((n, d)) + 0.01).astype(np.float32)


def _obs_ws(seed, n=40, d=8, **cfg):
    config = ExecConfig(obs=OBS, device="cpu", **cfg)
    return Workspace.from_features(_features(seed, n, d), config=config)


def _jax_obs_ws(seed, n=40, d=8):
    config = JaxExecConfig(obs=jax_obs.ObsConfig(enabled=True, probe=False))
    return JaxWorkspace.from_features(_features(seed, n, d), config=config)


def _dm(n, seed=0):
    return random_distance_matrix(seed, n, device="cpu").data.numpy()


def _orders(k, n):
    return torch.from_numpy(np.array(jax_orders(KEY, k, n)))


def _omega(k, n):
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(42), (n, sketch_width(k, n)))))


def _ops(ledger):
    """A ledger's totals by op: counts and floats."""
    return {op: (v["count"], v["floats"])
            for op, v in ledger["by_op"].items()}


# --------------------------------------------------------------------------
# registry parity: the ledger re-derives the committed accounting
# --------------------------------------------------------------------------
def test_registry_parity_mantel_headline():
    """10.97x (square gather) and 16.45x (the eager original) over the
    condensed loop at n = 2048, B = 32, from the port's copy."""
    floats = perm_traffic_floats(2048, 32)
    ratio = floats["square_gather"] / floats["condensed_fused"]
    assert ratio == pytest.approx(10.97, abs=0.005)
    assert floats["original"] / floats["condensed_fused"] == \
        pytest.approx(16.45, abs=0.005)
    assert floats["original"] > floats["square_gather"]
    assert floats == jax_obs.perm_traffic_floats(2048, 32)


def test_registry_parity_api_session_passes():
    """The four-analysis battery: 11 n²-passes on one session against 16
    for the calls made standalone, from the port's pass table."""
    shared = sum(HOIST_PASSES[a] for a in
                 ("operator", "gram", "condensed", "ranks", "coords"))
    assert shared == 11.0
    standalone = (
        (HOIST_PASSES["operator"] + HOIST_PASSES["coords"])    # pcoa
        + HOIST_PASSES["gram"]                                 # permanova
        + (HOIST_PASSES["operator"] + HOIST_PASSES["coords"])  # permdisp
        + (HOIST_PASSES["condensed"] + HOIST_PASSES["ranks"])  # anosim
    )
    assert standalone == 16.0
    assert HOIST_PASSES == jax_obs.HOIST_PASSES
    assert FEATURE_HOIST_PASSES == jax_obs.FEATURE_HOIST_PASSES


def test_feature_table_discounts():
    assert set(FEATURE_HOIST_PASSES) == set(HOIST_PASSES)
    for k in HOIST_PASSES:
        assert FEATURE_HOIST_PASSES[k] <= HOIST_PASSES[k], k
    assert FEATURE_HOIST_PASSES["operator"] == 0.0
    assert FEATURE_HOIST_PASSES["coords"] == 2.0


def test_production_floats_formula():
    assert production_floats(256, 32, 64) == 4 * 256 * 32 + 256 * 32
    assert production_floats(100, 10, 256) == 100 * 10 + 100 * 10  # b -> n
    assert production_floats(300, 17, 128) == \
        jax_obs.production_floats(300, 17, 128)


# --------------------------------------------------------------------------
# ledger
# --------------------------------------------------------------------------
def test_ledger_charges_and_totals():
    led, ref = Ledger(), jax_obs.Ledger()
    for lg in (led, ref):
        lg.charge_hoist("gram", 100)
        lg.charge_hoist("coords", 100, table=FEATURE_HOIST_PASSES)
        lg.charge_perm_batch("mantel", 100, permutations=64, batch=32)
        lg.charge_production(100, 8, 50)
    assert led.hoist_passes() == 4.0 + 2.0
    per = perm_traffic_floats(100, 32)["condensed_fused"]
    expect = (4.0 * 100 * 100 + 2.0 * 100 * 100 + per * 64
              + production_floats(100, 8, 50))
    assert led.total_floats() == pytest.approx(expect)
    assert led.total_bytes() == pytest.approx(4.0 * expect)
    assert set(led.by_op()) == {"hoist:gram", "hoist:coords",
                                "perm:mantel", "production"}
    assert led.by_op()["perm:mantel"]["count"] == 1
    entry = led.entries[2]
    assert entry.params["batch"] == 32
    assert entry.params["model"] == "condensed_fused"
    assert entry.bytes == 4.0 * entry.floats
    assert led.to_dict() == ref.to_dict()


# --------------------------------------------------------------------------
# span tracer
# --------------------------------------------------------------------------
def test_tracer_nesting_and_phase_accounting():
    t = Tracer()
    with t.span("outer", phase="hoist", n=10):
        with t.span("inner", phase="solve"):
            pass
        t.record("pre_timed", 0.5, phase="step")
    (root,) = t.spans
    assert root.name == "outer" and root.phase == "hoist"
    assert [c.name for c in root.children] == ["inner", "pre_timed"]
    assert root.duration >= root.children[0].duration
    assert t.count() == 3 and t.count("solve") == 1
    assert t.total("step") == pytest.approx(0.5)


def test_tracer_rejects_unknown_phase():
    with pytest.raises(ValueError, match="phase"):
        Tracer().span("x", phase="warp")


def test_span_end_before_begin_is_an_error():
    with pytest.raises(RuntimeError, match="before begin"):
        Tracer().span("x").end()


def test_tracer_exports_json_and_chrome_trace():
    t = Tracer()
    with t.span("a", phase="hoist", impl="xla"):
        with t.span("b", phase="per_perm"):
            pass
    tree = json.loads(t.to_json())
    assert tree[0]["name"] == "a"
    assert tree[0]["children"][0]["name"] == "b"
    assert tree[0]["phase"] == "hoist" and tree[0]["attrs"]["impl"] == "xla"
    lines = t.tree_lines()
    assert len(lines) == 2 and "a [hoist]" in lines[0]


def _profiled(fn):
    """``fn()`` under a CPU ``torch.profiler``: the count of each
    ``repro_torch.*`` span in the profile, and every event name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = [e.name for e in prof.events()]
    return Counter(n.removeprefix("repro_torch.") for n in names
                   if n.startswith("repro_torch.")), names


def test_spans_bridge_into_the_torch_profiler():
    """While a profiler records, every span opens a
    ``torch.profiler.record_function`` under its prefixed name, with no
    configuration asking for it; the tracer keeps the bare name."""
    t = Tracer()

    def run():
        with t.span("ws.bridge_probe", phase="solve"):
            torch.ones(8).sum()
        t.span("step", phase="step").begin().end()
    spans, names = _profiled(run)
    assert spans == {"ws.bridge_probe": 1, "step": 1}
    assert "ws.bridge_probe" not in names
    assert [s.name for s in t.spans] == ["ws.bridge_probe", "step"]
    assert t.spans[0].duration is not None


def test_free_mantel_spans_reach_the_profiler_without_a_session():
    """The order draw once and each tile of 32 permutations, K = 99."""
    from repro_torch.core import mantel
    x, y = (random_distance_matrix(s, 40, device="cpu") for s in (1, 2))
    spans, names = _profiled(lambda: mantel(x, y, permutations=99, key=3,
                                            device="cpu"))
    assert spans["engine.orders"] == 1 and spans["engine.tile"] == 4
    assert spans["engine.mantel"] == spans["ws.mantel"] == 1
    assert not {"engine.orders", "engine.tile", "ws.mantel"} & set(names)


@pytest.mark.parametrize("backing", ["square", "condensed"])
def test_operator_pcoa_matvec_spans(backing):
    """``2 + POWER_ITERS`` products of either operator, each a span."""
    from repro_torch.core import pcoa
    from repro_torch.core.pcoa import POWER_ITERS
    if backing == "square":
        dm = random_distance_matrix(1, 40, device="cpu")
        spans, _ = _profiled(lambda: pcoa(dm, dimensions=5, device="cpu"))
        assert spans["pcoa.fsvd"] == 1
    else:
        ws = Workspace.from_features(_features(2), config=ExecConfig(
            device="cpu"))
        ws.condensed()
        spans, _ = _profiled(lambda: ws.pcoa(dimensions=5))
    assert spans["operator.matvec"] == 2 + POWER_ITERS


def test_production_panel_spans():
    """n = 70 in panels of 32: three ``dist.panel`` spans."""
    from repro_torch.dist.driver import pairwise_condensed
    spans, _ = _profiled(lambda: pairwise_condensed(
        _features(3, n=70), block=32, device="cpu"))
    assert spans == {"dist.pairwise_condensed": 1, "dist.panel": 3}


def test_session_span_tree_holds_the_order_draw():
    """Under a session the draw and the tiles are children of the
    ``engine.<method>`` span, given orders too; in a profile the
    session's spans carry the prefix."""
    d, e = _dm(40, seed=1), _dm(40, seed=2)
    ws = Workspace(d, config=ExecConfig(obs=OBS, device="cpu"))
    spans, names = _profiled(lambda: ws.mantel(e, permutations=99, key=3))
    ws.mantel(e, permutations=64, orders=_orders(64, 40))
    engines = [c for s in ws.report().spans if s["name"] == "ws.mantel"
               for c in s.get("children", ())
               if c["name"] == "engine.mantel"]
    assert len(engines) == 2
    for engine, tiles in zip(engines, (4, 2)):
        kids = [c["name"] for c in engine["children"]]
        assert kids == ["engine.orders"] + ["engine.tile"] * tiles
    assert engines[1]["children"][0]["attrs"]["given"] is True
    assert spans["ws.mantel"] == spans["engine.orders"] == 1
    assert not {"ws.mantel", "engine.mantel", "engine.orders"} & set(names)


def _engine_span(ws, method):
    """The newest ``engine.<method>`` span of ``ws``'s report."""
    return [c for s in ws.report().spans if s["name"] == f"ws.{method}"
            for c in s.get("children", ())
            if c["name"] == f"engine.{method}"][-1]


def test_drawn_orders_are_drawn_a_tile_ahead():
    """K = 99 in tiles of 32: tiles 1-3 are drawn inside the tile before
    them, each in an ``engine.orders_ahead`` span a child of an
    ``engine.tile``; given orders draw nothing ahead."""
    d, e = _dm(40, seed=1), _dm(40, seed=2)
    ws = Workspace(d, config=ExecConfig(obs=OBS, device="cpu"))
    spans, names = _profiled(lambda: ws.mantel(e, permutations=99, key=3))
    engine = _engine_span(ws, "mantel")
    assert engine["attrs"]["draws_ahead"] == 3
    assert [c["name"] for c in engine["children"]] == \
        ["engine.orders"] + ["engine.tile"] * 4
    ahead = [(t, c) for t, tile in enumerate(engine["children"][1:])
             for c in tile.get("children", ())
             if c["name"] == "engine.orders_ahead"]
    assert [(t, c["attrs"]) for t, c in ahead] == [
        (0, {"rows": 32, "tile": 1}), (1, {"rows": 32, "tile": 2}),
        (2, {"rows": 3, "tile": 3})]
    assert spans["engine.orders_ahead"] == 3 and spans["engine.orders"] == 1
    assert spans["engine.tile"] == 4
    assert "engine.orders_ahead" not in names
    spans, _ = _profiled(lambda: ws.mantel(e, permutations=64,
                                           orders=_orders(64, 40)))
    engine = _engine_span(ws, "mantel")
    assert engine["attrs"]["draws_ahead"] == 0
    assert "engine.orders_ahead" not in spans
    assert not any(c["name"] == "engine.orders_ahead"
                   for tile in engine["children"]
                   for c in tile.get("children", ()))


@pytest.mark.parametrize("method,k", [
    ("mantel", 99), ("partial_mantel", 40), ("permanova", 64),
    ("anosim", 17), ("permdisp", 33), ("mantel", 0)])
def test_every_workspace_test_reports_its_draws_ahead(method, k):
    """``draws_ahead`` on the ``engine.<method>`` span: tiles − 1 for
    drawn orders, whatever the statistic."""
    d, e, f = (_dm(40, seed=s) for s in (1, 2, 3))
    ws = Workspace(d, config=ExecConfig(obs=OBS, device="cpu"))
    grouping = np.arange(40) % 4
    call = {"mantel": lambda: ws.mantel(e, permutations=k, key=1),
            "partial_mantel": lambda: ws.partial_mantel(e, f,
                                                        permutations=k,
                                                        key=1),
            "permanova": lambda: ws.permanova(grouping, permutations=k,
                                              key=1),
            "anosim": lambda: ws.anosim(grouping, permutations=k, key=1),
            "permdisp": lambda: ws.permdisp(grouping, permutations=k,
                                            key=1)}[method]
    call()
    attrs = _engine_span(ws, method)["attrs"]
    assert attrs["draws_ahead"] == max(attrs["tiles"] - 1, 0)
    assert attrs["tiles"] == -(-k // 32)


def test_the_off_path_is_the_shared_null_span():
    """No profiler, no session: the shared ``NULL_SPAN``; a session
    without spans too. Under a profiler the no-op session's span is seen
    by the profiler and nowhere else."""
    from repro_torch.obs.report import ObsSession
    from repro_torch.obs.trace import profiled_span, profiling
    assert not profiling()
    assert current_obs().span("engine.tile", rows=32) is NULL_SPAN
    assert profiled_span("x") is NULL_SPAN
    assert ObsSession(ObsConfig(enabled=True, spans=False)).span(
        "ws.x") is NULL_SPAN
    seen = []

    def run():
        with NULL_OBS.span("engine.orders") as span:
            seen.append(span)
    spans, _ = _profiled(run)
    assert spans == {"engine.orders": 1} and seen[0] is not NULL_SPAN


def test_ambient_session_stack():
    class FakeSession:
        enabled = True

    s = FakeSession()
    t = Tracer()
    assert current_obs() is NULL_OBS
    with t.span("outer", session=s):
        assert current_obs() is s
    assert current_obs() is NULL_OBS


# --------------------------------------------------------------------------
# the disabled path
# --------------------------------------------------------------------------
def test_null_singletons_are_process_wide():
    assert NULL_OBS.span("anything", phase="hoist", n=10) is NULL_SPAN
    assert NULL_SPAN.__enter__() is NULL_SPAN
    assert NULL_SPAN.add(x=1) is NULL_SPAN
    assert NULL_SPAN.begin().end() is NULL_SPAN
    assert NULL_OBS.charge_hoist("gram", 100) is None
    assert not NULL_OBS.enabled
    ws = Workspace(_dm(12), config=ExecConfig(device="cpu"))
    assert ws.obs is NULL_OBS
    assert ws.cache.obs is NULL_OBS


def test_disabled_span_fast_path_overhead():
    """The disabled span path costs well under 20 µs a call."""
    calls = 20_000
    t0 = time.perf_counter()
    for _ in range(calls):
        with current_obs().span("engine.x", phase="per_perm", n=40,
                                permutations=999, batch_size=32):
            pass
    assert (time.perf_counter() - t0) / calls < 20e-6


# --------------------------------------------------------------------------
# call sentinel
# --------------------------------------------------------------------------
def test_sentinel_counts_traces_and_programs():
    s = CompileSentinel()
    s.note("f", (10, 32))
    s.note("f", (10, 32))
    s.note("f", (20, 32))
    s.note("g")                       # signature-less: call count only
    assert s.traces("f") == 3 and s.programs("f") == 2
    assert s.traces("g") == 1 and s.programs("g") == 0
    snap = s.snapshot()
    s.note("f", (30, 32))
    assert s.since(snap) == {"f": {"traces": 1, "programs": 1}}
    assert s.since(s.snapshot()) == {}


def test_sentinel_expect_raises_on_budget_breach():
    s = CompileSentinel()
    with s.expect("f", max_programs=1):
        s.note("f", (1,))
    with pytest.raises(RecompileError, match="distinct programs"):
        with s.expect("f", max_programs=1):
            s.note("f", (2,))
            s.note("f", (3,))
    with pytest.raises(RecompileError, match="traces"):
        with s.expect("g", max_programs=9, max_traces=1):
            s.note("g")
            s.note("g")


def test_one_permute_reduce_program_serves_any_k():
    """One padded tile of B serves any K with one signature: two Mantel
    runs of different K add ``permute_reduce`` calls (one a tile: 2 + 1)
    but one program, and the engine's per_batch entry is noted once a
    run with one program. n = 53 is unique to this test among the port's,
    so the signature is new in the process."""
    ws, wsy = _obs_ws(0, n=53), _obs_ws(1, n=53)
    base = sentinel.snapshot()
    with sentinel.expect("kernels.permute_reduce", max_programs=1):
        ws.mantel(wsy, permutations=49)            # 2 padded tiles of 32
        ws.mantel(wsy, permutations=17)            # 1 padded tile
    delta = sentinel.since(base)
    assert delta["kernels.permute_reduce"] == {"traces": 3, "programs": 1}
    assert delta["stats.engine.per_batch"] == {"traces": 2, "programs": 1}
    assert delta["stats.engine.tile"] == {"traces": 3, "programs": 1}
    assert delta["stats.engine.null_distribution"]["programs"] == 2


# --------------------------------------------------------------------------
# RunReport: the instrumented battery end to end
# --------------------------------------------------------------------------
@pytest.fixture
def own_jax_compile_window(monkeypatch):
    """The reference runs on a compile sentinel of its own and leaves the
    jit caches cold: both are process-wide, and ``tests/test_obs.py``'s
    battery report, at the same shapes in the same worker, counts the
    programs first traced inside its own window."""
    fresh = jax_obs.CompileSentinel()
    monkeypatch.setattr(repro.obs.compile, "sentinel", fresh)
    monkeypatch.setattr(repro.obs.report, "sentinel", fresh)
    yield
    jax.clear_caches()


def test_feature_backed_battery_report(own_jax_compile_window):
    """The six-analysis battery on an observing feature-backed session:
    the ledger carries every hoist, permutation batch and the production
    sweep once, 4.0 hoist passes, and equals the reference's ledger
    totals; the spans nest; the cache and call sections are live."""
    g = np.arange(40) % 4
    o, om = _orders(49, 40), _omega(5, 40)
    ws, wsy, wsz = _obs_ws(2), _obs_ws(3), _obs_ws(4)
    ws.pcoa(dimensions=5, omega=om)
    ws.permanova(g, permutations=49, orders=o)
    ws.permdisp(g, permutations=49, dimensions=5, orders=o, omega=om)
    ws.anosim(g, permutations=49, orders=o)
    ws.mantel(wsy, permutations=49, orders=o)
    ws.partial_mantel(wsy, wsz, permutations=49, orders=o)
    ref, refy, refz = _jax_obs_ws(2), _jax_obs_ws(3), _jax_obs_ws(4)
    ref.pcoa(dimensions=5)
    ref.permanova(g, permutations=49, key=KEY)
    ref.permdisp(g, permutations=49, key=KEY, dimensions=5)
    ref.anosim(g, permutations=49, key=KEY)
    ref.mantel(refy, permutations=49, key=KEY)
    ref.partial_mantel(refy, refz, permutations=49, key=KEY)

    rep = ws.report(meta={"suite": "test"})
    want = ref.report()
    assert isinstance(rep, RunReport)
    assert rep.meta["backing"] == "features" and rep.meta["suite"] == "test"
    assert set(rep.measured) == {"kernels.permute_reduce",
                                 "dist.panel_stats", "pcoa.fsvd_matfree"}
    assert ({(v["name"], v["quantity"]) for v in rep.drift["verdicts"]}
            == {(name, q) for name in ("kernels.permute_reduce",
                                       "dist.panel_stats")
                for q in ("bytes", "peak")})
    assert rep.drift_ok
    by_op = rep.ledger["by_op"]
    for op in ("production", "hoist:condensed", "hoist:operator",
               "hoist:coords", "hoist:ranks", "hoist:moments",
               "perm:mantel", "perm:partial_mantel", "perm:anosim"):
        assert by_op[op]["count"] == 1, op
    assert rep.hoist_passes == pytest.approx(4.0)
    assert rep.total_bytes == pytest.approx(4.0 * rep.ledger["total_floats"])
    per = perm_traffic_floats(40, 32)["condensed_fused"]
    assert by_op["perm:mantel"]["floats"] == pytest.approx(per * 64)
    assert rep.ledger["perm_model"].startswith("reference model (Pallas)")
    assert _ops(rep.ledger) == _ops(want.ledger)
    assert rep.hoist_passes == want.hoist_passes

    roots = [s["name"] for s in rep.spans]
    for name in ("ws.pcoa", "ws.permanova", "ws.permdisp", "ws.anosim",
                 "ws.mantel", "ws.partial_mantel"):
        assert name in roots, name
    pcoa_span = rep.spans[roots.index("ws.pcoa")]
    nested = [c["name"] for c in pcoa_span.get("children", ())]
    assert "hoist:coords" in nested
    assert rep.cache["misses"]
    # Mantel and partial Mantel through permute_reduce, ANOSIM through
    # within_sums: 2 tiles each
    assert rep.compile["kernels.permute_reduce"]["traces"] == 4
    assert rep.compile["kernels.within_sums"]["traces"] == 2
    assert rep.compile["stats.engine.per_batch"]["traces"] == 5
    doc = json.loads(rep.to_json())
    assert doc["meta"]["n"] == 40
    assert doc["ledger"]["hoist_passes"] == pytest.approx(4.0)


def test_square_backed_battery_reproduces_bench_api_11_passes():
    """The square-backed battery (pcoa + permanova + permdisp + anosim)
    charges 11 n²-passes on one session, and 16 as four one-shot sessions,
    as the reference does."""
    n = 36
    d = _dm(n)
    g = np.arange(n) % 3
    o, om = _orders(49, n), _omega(5, n)
    obs = ExecConfig(obs=OBS, device="cpu")
    ws = Workspace(d, config=obs)
    ws.pcoa(dimensions=5, omega=om)
    ws.permanova(g, permutations=49, orders=o)
    ws.permdisp(g, permutations=49, dimensions=5, orders=o, omega=om)
    ws.anosim(g, permutations=49, orders=o)
    rep = ws.report()
    assert rep.meta["backing"] == "distance_matrix"
    assert rep.hoist_passes == pytest.approx(11.0)
    assert rep.ledger["by_op"]["hoist:gram"]["floats"] == 4.0 * n * n
    ref = JaxWorkspace(d, config=JaxExecConfig(
        obs=jax_obs.ObsConfig(enabled=True, probe=False)))
    ref.pcoa(dimensions=5)
    ref.permanova(g, permutations=49, key=KEY)
    ref.permdisp(g, permutations=49, key=KEY, dimensions=5)
    ref.anosim(g, permutations=49, key=KEY)
    assert _ops(rep.ledger) == _ops(ref.report().ledger)

    calls = [lambda w: w.pcoa(dimensions=5, omega=om),
             lambda w: w.permanova(g, permutations=49, orders=o),
             lambda w: w.permdisp(g, permutations=49, dimensions=5,
                                  orders=o, omega=om),
             lambda w: w.anosim(g, permutations=49, orders=o)]
    standalone = 0.0
    for call in calls:
        one_shot = Workspace(d, config=obs)
        call(one_shot)
        standalone += one_shot.report().hoist_passes
    assert standalone == pytest.approx(16.0)


def test_disabled_report_still_carries_cache_and_sentinel():
    ws = Workspace(_dm(12), config=ExecConfig(device="cpu"))
    ws.pcoa(dimensions=3)
    rep = ws.report()
    assert rep.spans == [] and rep.ledger == {}
    assert rep.meta["obs_enabled"] is False
    assert any("coords" in k for k in rep.cache["misses"])
    assert rep.compile == sentinel.snapshot()


def test_report_save_roundtrip(tmp_path):
    ws = _obs_ws(5, n=16, d=4)
    ws.pcoa(dimensions=3)
    path = str(tmp_path / "report.json")
    ws.report().save(path)
    with open(path) as f:
        doc = json.load(f)
    assert doc["meta"]["n"] == 16 and doc["spans"]
    assert set(doc["measured"]) == {"kernels.permute_reduce",
                                    "dist.panel_stats", "pcoa.fsvd_matfree"}
    assert doc["drift"]["within_tolerance"] is True


def test_spans_accumulate_across_refresh_generations():
    ws = _obs_ws(6, n=16, d=4)
    ws.pcoa(dimensions=3)
    ws.refresh()
    ws.pcoa(dimensions=3)
    rep = ws.report()
    assert rep.meta["generation"] == 1
    assert rep.ledger["by_op"]["hoist:coords"]["count"] == 2
    assert sum(rep.cache["misses"].values()) < len(rep.ledger["entries"])


# --------------------------------------------------------------------------
# config plumbing
# --------------------------------------------------------------------------
def test_obs_config_validation_and_execconfig_integration():
    with pytest.raises(ValueError):
        ObsConfig(enabled="yes")
    with pytest.raises(ValueError, match="obs"):
        ExecConfig(obs="on")
    assert ExecConfig(obs=None) == ExecConfig()
    assert hash(ExecConfig(obs=ObsConfig())) == hash(ExecConfig())
    assert ExecConfig(obs=ObsConfig(enabled=True)) != ExecConfig()
    assert not ExecConfig().obs.enabled
    ref = jax_obs.ObsConfig()
    assert {f: getattr(ObsConfig(), f) for f in ObsConfig.__annotations__} \
        == {f: getattr(ref, f) for f in jax_obs.ObsConfig.__annotations__}


def test_build_report_without_session():
    rep = build_report(None, cache=None, meta={"x": 1})
    assert rep.meta["x"] == 1 and rep.cache == {}
    assert rep.spans == [] and rep.ledger == {}
    assert rep.meta["torch"] == torch.__version__
