"""``repro_torch.serve`` on the CPU: the cases of ``tests/test_serve.py``
through the port's service, the observed statistics held against the
reference service's on the same studies, and the chaos soak's counts held
against ``BENCH_serve.json``.

Tolerances. The observed statistics do not depend on the seed, so they
are held against the reference's at its own tolerances: 1e-5, PERMDISP
1e-4·max(|s|, 1), PCoA's proportions explained rtol 1e-4 (``PERF.md``
§2). The port's seeds draw other orders than the reference's keys, so
p-values are held bitwise against the port's own standalone
``Workspace`` with the same seed. The soak's counts are control flow
(which site invocations fire, which tiles retry) and must be the
reference's exactly.
"""

import json
import math
import os

import numpy as np
import pytest

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro_torch.api.config import ExecConfig
from repro_torch.api.workspace import Workspace
from repro_torch.faults import FaultPlan
from repro_torch.obs.compile import RecompileError, sentinel
from repro_torch.runtime.monitor import StepMonitor
from repro_torch.serve import (AnalysisService, Rejected, RequestQueue,
                               ServeConfig, SessionPool, partial_bounds,
                               serve_report, validate_upload)

CPU = ExecConfig(device="cpu")


def _features(n, d, seed=0):
    return np.random.default_rng(seed).random((n, d)).astype(np.float32)


def _service(**kw):
    kw.setdefault("timeout_s", None)
    kw.setdefault("auto_tune", False)
    kw.setdefault("batch_size", 16)
    kw.setdefault("device", "cpu")
    return AnalysisService(ServeConfig(**kw))


GROUPING = np.array(["a", "b", "c"] * 8)          # n=24


@pytest.fixture
def svc():
    s = _service()
    s.upload("x", features=_features(24, 6, seed=1))
    s.upload("y", features=_features(24, 5, seed=2))
    s.upload("z", features=_features(24, 4, seed=3))
    return s


# --------------------------------------------------------------------------
# Coalescing determinism — THE acceptance property
# --------------------------------------------------------------------------
class TestCoalescingDeterminism:
    @pytest.mark.parametrize("k", [17, 49, 999])
    def test_alone_vs_coalesced_bitwise(self, svc, k):
        # coalesced: the K-under-test shares tiles with two strangers
        h = svc.submit("x", "mantel", other="y", permutations=k, key=5)
        svc.submit("x", "mantel", other="y", permutations=33, key=11)
        svc.submit("x", "mantel", other="y", permutations=77, key=12)
        svc.run()
        # alone: a fresh service, nothing to share with
        solo = _service()
        solo.upload("x", features=_features(24, 6, seed=1))
        solo.upload("y", features=_features(24, 5, seed=2))
        hs = solo.submit("x", "mantel", other="y", permutations=k, key=5)
        solo.run()
        assert h.result.p_value == hs.result.p_value
        assert h.result.statistic == hs.result.statistic

    def test_mixed_k_single_program(self, svc):
        with sentinel.expect("kernels.permute_reduce", max_programs=1):
            for k, key in ((17, 0), (49, 1), (999, 2)):
                svc.submit("x", "mantel", other="y", permutations=k,
                           key=key)
            svc.submit("x", "anosim", grouping=GROUPING, permutations=49,
                       key=3)
            svc.run()
        assert sentinel.expect is not None  # the context not raising IS
        # the assertion (RecompileError on >1 program)

    def test_recompile_error_class_importable(self):
        assert issubclass(RecompileError, Exception)


# --------------------------------------------------------------------------
# Serve vs library parity — all six analyses through the front door
# --------------------------------------------------------------------------
class TestServeLibraryParity:
    """p-values bitwise the port's standalone ``Workspace`` with the same
    seed (``tests/test_serve.py``)."""
    def _ws(self, seed, d):
        return Workspace.from_features(
            _features(24, d, seed=seed),
            config=ExecConfig(batch_size=16, device="cpu"))

    def test_permanova(self, svc):
        h = svc.submit("x", "permanova", grouping=GROUPING,
                       permutations=99, key=7)
        svc.run()
        ref = self._ws(1, 6).permanova(GROUPING, permutations=99, key=7)
        assert h.result.p_value == ref.p_value
        assert h.result.statistic == ref.statistic

    def test_anosim(self, svc):
        h = svc.submit("x", "anosim", grouping=GROUPING, permutations=99,
                       key=7)
        svc.run()
        ref = self._ws(1, 6).anosim(GROUPING, permutations=99, key=7)
        assert h.result.p_value == ref.p_value

    def test_permdisp(self, svc):
        h = svc.submit("x", "permdisp", grouping=GROUPING,
                       permutations=99, key=7, dimensions=4)
        svc.run()
        ref = self._ws(1, 6).permdisp(GROUPING, permutations=99, key=7,
                                      dimensions=4)
        assert h.result.p_value == ref.p_value

    def test_mantel(self, svc):
        h = svc.submit("x", "mantel", other="y", permutations=99, key=7)
        svc.run()
        ref = self._ws(1, 6).mantel(self._ws(2, 5), permutations=99, key=7)
        assert h.result.p_value == ref.p_value

    def test_partial_mantel(self, svc):
        h = svc.submit("x", "partial_mantel", other="y", control="z",
                       permutations=99, key=7)
        svc.run()
        ref = self._ws(1, 6).partial_mantel(self._ws(2, 5), self._ws(3, 4),
                                            permutations=99, key=7)
        assert h.result.p_value == ref.p_value

    def test_pcoa_serves_from_pool_cache(self, svc):
        h = svc.submit("x", "pcoa", dimensions=3)
        svc.run()
        assert h.status == "done"
        assert h.result.coordinates.shape == (24, 3)
        ws = svc.pool.get("x")
        # a second identical request is a cache hit, not a re-solve
        h2 = svc.submit("x", "pcoa", dimensions=3)
        svc.run()
        assert ws.cache.build_count("coords") == 1
        assert h2.status == "done"


# --------------------------------------------------------------------------
# Scheduling economics: tiles, hoists, slot reuse
# --------------------------------------------------------------------------
class TestSchedulingEconomics:
    def test_tile_bound_and_hoist_once(self, svc):
        ks = [17, 49, 99, 33]
        for i, k in enumerate(ks):
            svc.submit("x", "mantel", other="y", permutations=k, key=i)
        svc.run()
        assert svc.scheduler.tiles_run == math.ceil(sum(ks) / 16)
        ws = svc.pool.get("x")
        assert all(v == 1 for v in ws.cache.misses.values()), \
            dict(ws.cache.misses)
        # ledger: hoist ops charged exactly once each
        hoist_ops = [e.op for e in ws.obs.ledger.entries
                     if e.op.startswith("hoist:")]
        assert len(hoist_ops) == len(set(hoist_ops))

    def test_slot_reuse_fills_mid_tile(self, svc):
        # 17 + 15 = 32 = exactly two B=16 tiles IF the second request's
        # rows backfill the first's final partial tile
        svc.submit("x", "mantel", other="y", permutations=17, key=0)
        svc.submit("x", "mantel", other="y", permutations=15, key=1)
        svc.run()
        assert svc.scheduler.tiles_run == 2

    def test_different_lanes_do_not_coalesce(self, svc):
        # different grouping content -> different lane, own tiles
        g2 = np.array(["a", "b"] * 12)
        svc.submit("x", "permanova", grouping=GROUPING, permutations=17,
                   key=0)
        svc.submit("x", "permanova", grouping=g2, permutations=17, key=1)
        svc.run()
        assert svc.scheduler.tiles_run == 4      # 2 lanes x 2 tiles

    def test_streaming_monotone_envelope(self, svc):
        h = svc.submit("x", "mantel", other="y", permutations=999, key=3)
        svc.run()
        assert len(h.updates) == math.ceil(999 / 16)
        los = [u.p_lo for u in h.updates]
        his = [u.p_hi for u in h.updates]
        assert los == sorted(los)                 # nondecreasing
        assert his == sorted(his, reverse=True)   # nonincreasing
        p = h.result.p_value
        assert all(lo <= p <= hi for lo, hi in zip(los, his))
        assert los[-1] == p == his[-1]            # collapse onto final
        draws = [u.draws_done for u in h.updates]
        assert draws == sorted(draws) and draws[-1] == 999

    def test_partial_bounds_math(self):
        b = partial_bounds(c=3, draws_done=10, permutations=99)
        assert b["p_lo"] == pytest.approx(4 / 100)
        assert b["p_hi"] == pytest.approx((3 + 89 + 1) / 100)
        assert b["p_partial"] == pytest.approx(4 / 11)
        done = partial_bounds(c=3, draws_done=99, permutations=99)
        assert done["p_lo"] == done["p_hi"] == done["p_partial"]


# --------------------------------------------------------------------------
# Pool: LRU, byte budgets, generation invalidation
# --------------------------------------------------------------------------
class TestSessionPool:
    def test_lru_eviction_by_count(self):
        pool = SessionPool(max_sessions=2)
        cfg = CPU
        for sid in ("a", "b", "c"):
            pool.admit(sid, cfg, features=_features(8, 3))
        assert len(pool) == 2 and "a" not in pool
        assert pool.evictions == 1

    def test_lru_touch_on_get(self):
        pool = SessionPool(max_sessions=2)
        cfg = CPU
        pool.admit("a", cfg, features=_features(8, 3))
        pool.admit("b", cfg, features=_features(8, 3))
        pool.get("a")                      # touch: b becomes LRU
        pool.admit("c", cfg, features=_features(8, 3))
        assert "a" in pool and "b" not in pool

    def test_byte_budget_eviction(self):
        pool = SessionPool(max_sessions=10, max_bytes=1)
        cfg = CPU
        ws_a = pool.admit("a", cfg, features=_features(16, 4))
        ws_a.condensed()                   # make 'a' cost real bytes
        assert pool.nbytes() > 1
        pool.admit("b", cfg, features=_features(16, 4))
        assert "a" not in pool             # evicted to chase the budget

    def test_exclude_pins_survive(self):
        pool = SessionPool(max_sessions=1)
        cfg = CPU
        pool.admit("a", cfg, features=_features(8, 3))
        pool.admit("b", cfg, features=_features(8, 3))
        # 'a' was evicted by b's admit; now protect b against everything
        assert pool.evict(exclude={"b"}) == []

    def test_reupload_bumps_generation_and_drops_cache(self, svc):
        ws = svc.pool.get("x")
        ws.condensed()
        g0, old_keys = ws.generation, set(ws.cache.keys())
        assert old_keys
        ack = svc.upload("x", features=_features(24, 6, seed=99))
        assert ack["generation"] == g0 + 1
        assert svc.pool.get("x") is ws      # same session object
        assert "condensed" not in ws.cache  # hoists dropped

    def test_nbytes_surfaced_in_workspace_report(self):
        ws = Workspace.from_features(_features(16, 4), config=CPU)
        ws.condensed()
        rep = ws.report()
        meta = rep.meta["cache_nbytes"]
        assert meta["total"] == ws.cache.nbytes() > 0
        assert meta["by_key"]["condensed"] > 0

    def test_nbytes_dedups_shared_buffers(self):
        ws = Workspace.from_features(_features(16, 4), config=CPU)
        ws.condensed()
        solo = ws.cache.nbytes()
        ws.operator()          # holds a reference to the same condensed
        assert ws.cache.nbytes() <= solo + 200   # means only, no double
        assert ws.cache.nbytes("operator") > 0   # per-key: full closure


# --------------------------------------------------------------------------
# Admission: structured rejection, queue bounds, timeouts
# --------------------------------------------------------------------------
class TestAdmission:
    def test_non_finite_upload_payload(self):
        svc = _service()
        bad = _features(8, 3).copy()
        bad[2, 1] = np.nan
        with pytest.raises(Rejected) as ei:
            svc.upload("s", features=bad)
        payload = ei.value.rejection.payload()
        assert payload["error"]["code"] == "non_finite"
        assert "traceback" not in str(payload).lower()

    def test_too_large_upload(self):
        svc = _service(max_n=16)
        with pytest.raises(Rejected) as ei:
            svc.upload("s", features=_features(17, 3))
        assert ei.value.rejection.code == "too_large"
        assert ei.value.rejection.detail["max_n"] == 16

    def test_triangle_guard_is_the_library_bound(self):
        from repro_torch.core.distance_matrix import MAX_TRIANGLE_N
        import inspect
        from repro_torch.serve.admission import validate_upload as vu
        # the admission cap defaults to the library's i32 triangle bound
        assert inspect.signature(vu).parameters["max_n"].default \
            == MAX_TRIANGLE_N == ServeConfig().max_n
        kind, n = validate_upload(features=_features(4, 2))
        assert (kind, n) == ("features", 4)
        kind, n = validate_upload(np.zeros((4, 4), np.float32))
        assert (kind, n) == ("dm", 4)

    def test_asymmetric_square_rejected_structured(self):
        svc = _service()
        m = np.arange(16, dtype=np.float32).reshape(4, 4)
        with pytest.raises(Rejected) as ei:
            svc.upload("s", m)
        assert ei.value.rejection.code == "bad_request"

    def test_unknown_study(self, svc):
        with pytest.raises(Rejected) as ei:
            svc.submit("nope", "permanova", grouping=GROUPING)
        assert ei.value.rejection.code == "unknown_study"

    def test_unknown_method(self, svc):
        with pytest.raises(Rejected) as ei:
            svc.submit("x", "tsne")
        assert ei.value.rejection.code == "bad_request"

    def test_queue_full_rejects_handle(self):
        svc = _service(max_queue=2)
        svc.upload("x", features=_features(24, 6, seed=1))
        svc.upload("y", features=_features(24, 5, seed=2))
        handles = [svc.submit("x", "mantel", other="y", permutations=9,
                              key=i) for i in range(3)]
        assert handles[2].status == "rejected"
        assert handles[2].error.code == "queue_full"
        svc.run()
        assert [h.status for h in handles[:2]] == ["done", "done"]

    def test_queued_timeout_fires(self, svc):
        h = svc.submit("x", "mantel", other="y", permutations=9,
                       timeout_s=-1.0)        # already expired
        svc.run()
        assert h.status == "timed_out"
        assert h.error.code == "timeout"

    def test_bad_grouping_is_structured_not_traceback(self, svc):
        h = svc.submit("x", "permanova", grouping=["a", "b"])  # wrong len
        svc.run()
        assert h.status == "rejected"
        assert h.error.code == "bad_request"

    def test_collinear_partial_mantel_structured(self, svc):
        svc.upload("ycopy", features=_features(24, 5, seed=2))  # z == y
        h = svc.submit("x", "partial_mantel", other="y", control="ycopy",
                       permutations=9)
        svc.run()
        assert h.status == "rejected"
        assert "collinear" in h.error.message

    def test_request_queue_bounds(self):
        q = RequestQueue(max_depth=1)

        class H:
            deadline = None
        q.push(H(), None)
        with pytest.raises(Rejected):
            q.push(H(), None)


# --------------------------------------------------------------------------
# Watchdog: the StepMonitor covers the tile loop
# --------------------------------------------------------------------------
class TestServeWatchdog:
    def test_tiles_flow_through_monitor(self, svc):
        svc.submit("x", "mantel", other="y", permutations=99, key=0)
        svc.run()
        mon = svc.scheduler.monitor
        assert len(mon.records) == svc.scheduler.tiles_run > 0
        assert all(r.seconds > 0 for r in mon.records)
        assert mon.deadline_factor == svc.config.deadline_factor

    def test_watchdog_fires_between_tiles(self):
        # regression: a tile that began but never completed must trip
        # the deadline on the NEXT loop turn's heartbeat, not hang
        mon = StepMonitor(deadline_factor=1.0)
        for i in range(4):
            mon.record(i, 1e-4)             # establish a tiny median
        mon.start()                          # a tile opens ... and stalls
        import time
        time.sleep(0.01)                     # >> deadline = 1e-4 s
        with pytest.raises(TimeoutError):
            mon.heartbeat()

    def test_heartbeat_noop_when_idle(self):
        mon = StepMonitor()
        mon.heartbeat()                      # no open step: no-op
        assert mon.elapsed() is None
        mon.start()
        assert mon.elapsed() >= 0.0
        mon.stop(0)
        assert mon.elapsed() is None


# --------------------------------------------------------------------------
# Reporting
# --------------------------------------------------------------------------
class TestServeReport:
    def test_report_sections(self, svc):
        svc.submit("x", "mantel", other="y", permutations=33, key=0)
        svc.submit("x", "permanova", grouping=GROUPING, permutations=17,
                   key=1)
        svc.run()
        rep = serve_report(svc)
        assert rep["gauges"]["completed"] == 2
        assert rep["gauges"]["latency_s"]["median"] > 0
        assert rep["pool"]["sessions"] == 3
        assert rep["pool"]["nbytes"] == svc.pool.nbytes() > 0
        assert rep["scheduler"]["tiles_run"] == svc.scheduler.tiles_run
        x = rep["studies"]["x"]
        assert x["ledger"]["hoist_passes"] > 0
        assert all(v == 1 for v in x["hoist_builds"].values())
        assert rep["monitor"]["steps"] == svc.scheduler.tiles_run
        # request latencies entered the span stream as serve-phase spans
        names = [s["name"] for s in rep["spans"]]
        assert any(n.startswith("request:mantel") for n in names)

    def test_latency_histograms_in_report(self, svc):
        svc.submit("x", "mantel", other="y", permutations=33, key=0)
        svc.submit("x", "permanova", grouping=GROUPING, permutations=17,
                   key=1)
        svc.run()
        lat = serve_report(svc)["latency"]
        assert set(lat) == {"queue_wait_s", "tile_s", "request_s"}
        req = lat["request_s"]
        assert req["count"] == 2
        assert req["p50"] > 0 and req["p95"] >= req["p50"]
        assert req["p99"] <= req["max"]
        # every executed tile was timed through the StepMonitor span
        assert lat["tile_s"]["count"] == svc.scheduler.tiles_run
        # both requests waited in the queue before activation
        assert lat["queue_wait_s"]["count"] == 2

    def test_slo_breach_counters(self):
        # thresholds of 0 seconds: every sample is a breach — the
        # counters must tick without affecting results
        s = _service(slo_queue_wait_s=0.0, slo_tile_s=0.0,
                     slo_request_s=0.0)
        s.upload("x", features=_features(24, 6, seed=1))
        s.upload("y", features=_features(24, 5, seed=2))
        h = s.submit("x", "mantel", other="y", permutations=33, key=0)
        s.run()
        assert h.status == "done"
        slo = serve_report(s)["slo"]
        assert slo["thresholds_s"] == {"queue_wait": 0.0, "tile": 0.0,
                                       "request": 0.0}
        assert slo["breaches"]["request"] == 1
        assert slo["breaches"]["tile"] == s.scheduler.tiles_run
        assert slo["breaches"]["queue_wait"] == 1
        # unset thresholds -> empty map, zero breaches (default svc)
        s2 = _service()
        assert serve_report(s2)["slo"] == {
            "thresholds_s": {},
            "breaches": {"queue_wait": 0, "tile": 0, "request": 0}}

    def test_prometheus_exposition(self, svc):
        svc.submit("x", "mantel", other="y", permutations=33, key=0)
        svc.run()
        text = svc.metrics.prometheus()
        assert "# TYPE serve_request_seconds histogram" in text
        assert 'serve_request_seconds_bucket{le="+Inf"} 1' in text
        assert "serve_slo_breach_request_total 0.0" in text

    def test_rejections_counted_in_gauges(self, svc):
        with pytest.raises(Rejected):
            svc.submit("ghost", "permanova", grouping=GROUPING)
        assert svc.report()["gauges"]["rejected"]["unknown_study"] == 1

    def test_async_driver(self, svc):
        import asyncio

        async def client():
            h = svc.submit("x", "mantel", other="y", permutations=33,
                           key=0)
            await svc.wait(h)
            return h

        h = asyncio.run(asyncio.wait_for(client(), 300))
        assert h.status == "done"


# --------------------------------------------------------------------------
# The port against the reference service
# --------------------------------------------------------------------------
def test_observed_statistics_match_the_reference_service():
    """Every method through both front doors on the same three studies
    (two feature tables and one square): the observed statistics agree at
    the reference's tolerances, whatever either side's seed. The fsvd
    sketch is drawn from a seed too, so PCoA and PERMDISP's ordination
    run ``pcoa_method="eigh"`` here."""
    from repro.serve import AnalysisService as JaxService
    from repro.serve import ServeConfig as JaxServeConfig
    ref = JaxService(JaxServeConfig(timeout_s=None, auto_tune=False,
                                    batch_size=16))
    port = _service()
    square = Workspace.from_features(_features(24, 4, seed=3),
                                     config=CPU).dm.data.numpy()
    for svc in (ref, port):
        svc.upload("x", features=_features(24, 6, seed=1))
        svc.upload("y", features=_features(24, 5, seed=2))
        svc.upload("z", square)
    requests = [("permanova", {"grouping": GROUPING}),
                ("anosim", {"grouping": GROUPING}),
                ("permdisp", {"grouping": GROUPING, "dimensions": 4,
                              "pcoa_method": "eigh"}),
                ("mantel", {"other": "y"}),
                ("partial_mantel", {"other": "y", "control": "z"})]
    got, want = {}, {}
    for svc, out in ((port, got), (ref, want)):
        for study in ("x", "z"):
            for method, kw in requests:
                if study == "z" and method in ("mantel", "partial_mantel"):
                    kw = {"other": "x", "control": "y"} \
                        if method == "partial_mantel" else {"other": "x"}
                out[study, method] = svc.submit(study, method,
                                                permutations=19, **kw)
            out[study, "pcoa"] = svc.submit(study, "pcoa", dimensions=3,
                                            pcoa_method="eigh")
        svc.run()
    for key, h in got.items():
        w = want[key]
        assert h.status == w.status == "done", key
        if key[1] == "pcoa":
            np.testing.assert_allclose(
                h.result.proportion_explained.numpy(),
                np.asarray(w.result.proportion_explained), rtol=1e-4)
            continue
        tol = 1e-4 * max(abs(w.result.statistic), 1.0) \
            if key[1] == "permdisp" else 1e-5
        assert abs(h.result.statistic - w.result.statistic) <= tol, key


def test_coalescing_economics_match_bench_serve():
    """``BENCH_serve.json``'s coalescing gates at a small n: twelve Mantel
    requests at its mixed K on one lane run ceil(ΣK/B) tiles against
    Σ ceil(K/B) one by one (the 1.05 tile ratio), every hoist is charged
    once, and the ledger's perm traffic is tiles × B × condensed_fused."""
    from repro_torch.obs.ledger import perm_traffic_floats
    with open("BENCH_serve.json") as f:
        bench = json.load(f)
    want = bench["results"]["512"]
    n, batch = 40, bench["batch"]
    rng = np.random.default_rng(0)
    svc = AnalysisService(ServeConfig(batch_size=batch, timeout_s=None,
                                      max_active=bench["requests"],
                                      auto_tune=False, device="cpu"))
    svc.upload("x", features=rng.random((n, 32)).astype(np.float32))
    svc.upload("y", features=rng.random((n, 32)).astype(np.float32))
    ks = want["per_request_k"]
    handles = [svc.submit("x", "mantel", other="y", permutations=k, key=i)
               for i, k in enumerate(ks)]
    svc.run()
    assert all(h.status == "done" for h in handles)
    tiles = svc.scheduler.tiles_run
    assert tiles == math.ceil(sum(ks) / batch) == want["tiles_coalesced"]
    per_request = sum(math.ceil(k / batch) for k in ks)
    assert per_request == want["tiles_per_request"]
    assert round(per_request / tiles, 2) == want["tile_ratio"]
    ws = svc.pool.get("x")
    assert dict(ws.cache.misses) == want["hoist_builds"]
    ops = [e.op for e in ws.obs.ledger.entries if e.op.startswith("hoist:")]
    assert len(ops) == len(set(ops))
    per_perm = perm_traffic_floats(n, batch)["condensed_fused"]
    floats = sum(e.floats for e in ws.obs.ledger.entries
                 if e.op == "perm:serve:mantel")
    assert floats == pytest.approx(tiles * batch * per_perm, rel=1e-12)


# --------------------------------------------------------------------------
# The chaos soak against BENCH_serve.json's receipts
# --------------------------------------------------------------------------
CHAOS_RATES = dict(tile_error=0.10, oom=0.03, nan=0.03, slow=0.0,
                   compile_rate=0.20)


def _chaos_bench():
    with open("BENCH_serve.json") as f:
        return json.load(f)["chaos"]


def _soak_pair(chaos, **cfg):
    """The soak's service (``benchmarks/bench_serve.py``'s ``_serve_pair``):
    two feature studies of n rows and 32 features, Mantel requests."""
    rng = np.random.default_rng(0)
    svc = AnalysisService(ServeConfig(
        batch_size=chaos["batch"], timeout_s=None,
        max_active=chaos["requests"], auto_tune=False, device="cpu", **cfg))
    svc.upload("x", features=rng.random((chaos["n"], 32)).astype(np.float32))
    svc.upload("y", features=rng.random((chaos["n"], 32)).astype(np.float32))
    handles = [svc.submit("x", "mantel", other="y", permutations=k, key=i)
               for i, k in enumerate(chaos["per_request_k"])]
    return svc, handles


@pytest.fixture(scope="module")
def soak_reference():
    chaos = _chaos_bench()
    svc, handles = _soak_pair(chaos)
    svc.run()
    assert all(h.status == "done" for h in handles)
    return {h.request_id: h.result.p_value for h in handles}


@pytest.mark.parametrize("seed", ["0", "1", "2"])
def test_chaos_soak_reproduces_bench_serve(seed, soak_reference):
    chaos = _chaos_bench()
    want = chaos["seeds"][seed]
    assert CHAOS_RATES == {k: chaos["rates"][k] for k in CHAOS_RATES}
    svc, handles = _soak_pair(chaos, fault_plan=FaultPlan.chaos(
        seed=int(seed), **CHAOS_RATES))
    svc.run()
    m = svc.metrics
    statuses = {s: sum(h.status == s for h in handles)
                for s in ("done", "degraded", "rejected")}
    assert statuses == want["statuses"]
    assert dict(m.faults) == want["injected"]
    assert dict(m.tile_failures) == want["tile_failures"]
    assert m.retries == want["retries"]
    assert m.retry_amplification == want["retry_amplification"]
    assert m.retry_amplification <= chaos["retry_amplification_cap"]
    assert m.breaker_trips == want["breaker_trips"]
    assert m.pool_sheds == want["pool_sheds"]
    done = [h for h in handles if h.status == "done"]
    assert len(done) == want["bitwise_completed"]
    assert all(h.result.p_value == soak_reference[h.request_id]
               for h in done)


def test_chaos_recovery_reproduces_bench_serve(tmp_path, soak_reference):
    chaos = _chaos_bench()
    want = chaos["recovery"]
    path = os.path.join(str(tmp_path), "serve.journal")
    svc, _ = _soak_pair(chaos, journal_path=path)
    total = math.ceil(sum(chaos["per_request_k"]) / chaos["batch"])
    assert total == want["tiles_total"]
    while svc.scheduler.tiles_run < want["crash_after_tiles"]:
        svc.step()
    pool = svc.pool
    svc.journal.close()
    before = {sid: dict(pool._sessions[sid].cache.misses)
              for sid in pool.studies()}
    svc2, handles = AnalysisService.recover(path, pool=pool, config=ServeConfig(
        batch_size=chaos["batch"], timeout_s=None,
        max_active=chaos["requests"], auto_tune=False, device="cpu"))
    svc2.run()
    assert svc2.scheduler.tiles_run == want["tiles_after_recovery"]
    assert all(dict(pool._sessions[sid].cache.misses) == before[sid]
               for sid in pool.studies())              # 0 re-hoists
    assert want["rehoists"] == 0
    assert svc2.metrics.resumes == want["resumed_requests"]
    assert svc2.metrics.resumed_rows == want["resumed_rows"]
    assert chaos["requests"] - len(handles) == want["already_terminal"]
    assert len(handles) == want["recovered_bitwise"]
    assert all(h.status == "done"
               and h.result.p_value == soak_reference[rid]
               for rid, h in handles.items())


def test_device_failures_leave_step(monkeypatch):
    """A kernel that cannot build or launch is not a transient fault: the
    scheduler raises it out of ``step()`` instead of retrying it into a
    degraded answer (the card test launches a failing kernel)."""
    from repro_torch.kernels._build import KernelError
    from repro_torch.serve.scheduler import is_device_failure
    from repro_torch.stats import engine
    import torch
    assert is_device_failure(KernelError("permute_reduce: CUDA error 700"))
    assert is_device_failure(RuntimeError("CUDA error: an illegal memory "
                                          "access was encountered"))
    assert not is_device_failure(torch.OutOfMemoryError("out of memory"))
    assert not is_device_failure(RuntimeError("transient"))
    svc = _service()
    svc.upload("x", features=_features(24, 6, seed=1))
    svc.upload("y", features=_features(24, 5, seed=2))
    h = svc.submit("x", "mantel", other="y", permutations=33, key=0)

    def broken(*args, **kwargs):
        raise KernelError("nvcc not found: the CUDA toolkit is needed")

    monkeypatch.setattr(engine, "tile_statistics", broken)
    with pytest.raises(KernelError, match="nvcc"):
        svc.run()
    assert h.status == "active" and not h.done
    assert svc.metrics.retries == 0 and svc.metrics.breaker_trips == 0
