"""``repro_torch.faults`` and the serve recovery plane: the cases of
``tests/test_faults.py`` through the port's service on the CPU, the fault
schedule held against the reference's (the same invocations fire for a
seed), and the journal's encoded lines held against the reference's.

Every p-value a test compares is the port's own (its seeds draw other
orders than the reference's keys): a request that survives faults is
bitwise the fault-free run of the port.
"""

import math
import time

import numpy as np
import pytest

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.checkpoint.journal import _encode as jax_encode
from repro.checkpoint.journal import replay as jax_replay
from repro.faults import FaultInjector as JaxInjector
from repro.faults import FaultPlan as JaxPlan
from repro.faults import FaultSpec as JaxSpec
from repro.faults import unit_hash as jax_unit_hash
from repro_torch.checkpoint.journal import Journal, _encode, replay
from repro_torch.faults import (SITES, FaultInjector, FaultPlan, FaultSpec,
                                unit_hash)
from repro_torch.serve import (AnalysisService, Rejected, ServeConfig,
                               serve_report)

PAYLOAD_KEYS = {"request_id", "study_id", "method", "status", "error",
                "progress", "result"}

GROUPING = np.array(["a", "b", "c"] * 8)          # n=24


def _features(n, d, seed=0):
    return np.random.default_rng(seed).random((n, d)).astype(np.float32)


def _service(**kw):
    kw.setdefault("timeout_s", None)
    kw.setdefault("auto_tune", False)
    kw.setdefault("batch_size", 16)
    kw.setdefault("device", "cpu")
    return AnalysisService(ServeConfig(**kw))


def _loaded(**kw):
    s = _service(**kw)
    s.upload("x", features=_features(24, 6, seed=1))
    s.upload("y", features=_features(24, 5, seed=2))
    s.upload("z", features=_features(24, 4, seed=3))
    return s


def _reference_p(method="mantel", permutations=99, key=5, **kw):
    """The fault-free answer for one request (fresh service, no plan)."""
    s = _loaded()
    h = s.submit("x", method, permutations=permutations, key=key, **kw)
    s.run()
    assert h.status == "done"
    return h.result.p_value


# --------------------------------------------------------------------------
# The plan: determinism and validation
# --------------------------------------------------------------------------
class TestFaultPlan:
    def test_unit_hash_deterministic_uniform(self):
        vals = [unit_hash(7, "site:0", i) for i in range(200)]
        assert vals == [unit_hash(7, "site:0", i) for i in range(200)]
        assert all(0.0 <= v < 1.0 for v in vals)
        # seed, label, and index all matter
        assert unit_hash(7, "site:0", 3) != unit_hash(8, "site:0", 3)
        assert unit_hash(7, "site:0", 3) != unit_hash(7, "site:1", 3)
        assert len(set(vals)) > 190       # not degenerate

    def test_schedule_replays_exactly(self):
        plan = FaultPlan.chaos(seed=3)
        a, b = FaultInjector(plan), FaultInjector(plan)
        for _ in range(50):
            a.poll("serve.tile")
            b.poll("serve.tile")
        a.poll("serve.hoist"), b.poll("serve.hoist")
        assert a.fires == b.fires
        assert a.summary() == b.summary()

    def test_seeds_decorrelate(self):
        def fires(seed):
            inj = FaultInjector(FaultPlan.chaos(seed=seed,
                                                tile_error=0.3))
            for _ in range(60):
                inj.poll("serve.tile")
            return [ev.index for ev in inj.fires]
        assert fires(0) != fires(1)

    def test_at_and_max_fires(self):
        inj = FaultInjector(FaultPlan(specs=(
            FaultSpec("serve.tile", "error", at=(1, 3, 5), max_fires=2),)))
        fired = [i for i in range(8) if inj.poll("serve.tile")]
        assert fired == [1, 3]            # max_fires caps the at-list

    def test_spec_validation(self):
        with pytest.raises(ValueError):
            FaultSpec("serve.nope", "error")
        with pytest.raises(ValueError):
            FaultSpec("serve.tile", "compile")     # wrong site's kind
        with pytest.raises(ValueError):
            FaultSpec("serve.tile", "error", rate=1.5)


# --------------------------------------------------------------------------
# The journal primitive
# --------------------------------------------------------------------------
class TestJournal:
    def test_roundtrip(self, tmp_path):
        path = str(tmp_path / "j.log")
        with Journal(path) as j:
            for i in range(5):
                j.append({"i": i, "x": "v" * i})
        assert [r["i"] for r in replay(path)] == list(range(5))

    def test_torn_tail_stops_replay(self, tmp_path):
        path = str(tmp_path / "j.log")
        with Journal(path) as j:
            for i in range(3):
                j.append({"i": i})
        with open(path, "a") as f:
            f.write('deadbeef {"i": 99}')       # bad crc, no newline
        assert [r["i"] for r in replay(path)] == [0, 1, 2]

    def test_corrupt_middle_truncates_suffix(self, tmp_path):
        path = str(tmp_path / "j.log")
        with Journal(path) as j:
            for i in range(4):
                j.append({"i": i})
        lines = open(path).read().splitlines(True)
        lines[1] = "00000000 {}\n"               # wrong crc mid-file
        open(path, "w").write("".join(lines))
        assert [r["i"] for r in replay(path)] == [0]

    def test_missing_file_replays_empty(self, tmp_path):
        assert list(replay(str(tmp_path / "absent.log"))) == []

    def test_reopen_appends_after_prefix(self, tmp_path):
        path = str(tmp_path / "j.log")
        with Journal(path) as j:
            j.append({"i": 0})
        with Journal(path) as j:
            j.append({"i": 1})
            assert [r["i"] for r in j.records()] == [0, 1]


# --------------------------------------------------------------------------
# Retry: transient faults are invisible in the answer
# --------------------------------------------------------------------------
class TestRetry:
    def test_transient_error_retried_bitwise(self):
        ref = _reference_p(other="y")
        plan = FaultPlan(seed=0, specs=(
            FaultSpec("serve.tile", "error", at=(0, 2)),))
        svc = _loaded(fault_plan=plan)
        h = svc.submit("x", "mantel", other="y", permutations=99, key=5)
        svc.run()
        assert h.status == "done"
        assert h.result.p_value == ref
        assert svc.metrics.retries == 2
        assert svc.metrics.tile_failures["transient"] == 2
        assert svc.metrics.retried_rows == 2 * 16
        assert svc.metrics.retry_amplification > 0

    def test_nan_poison_caught_and_retried(self):
        # a poisoned tile must NOT leak NaN rows into the exceedance
        # counts — the output admission check routes it through retry
        ref = _reference_p(other="y")
        plan = FaultPlan(seed=0, specs=(
            FaultSpec("serve.tile", "nan", at=(0,)),))
        svc = _loaded(fault_plan=plan)
        h = svc.submit("x", "mantel", other="y", permutations=99, key=5)
        svc.run()
        assert h.status == "done"
        assert h.result.p_value == ref
        assert svc.metrics.tile_failures["poison"] == 1

    def test_oom_sheds_idle_session_then_succeeds(self):
        ref = _reference_p("permanova", grouping=GROUPING)
        plan = FaultPlan(seed=0, specs=(
            FaultSpec("serve.tile", "oom", at=(0,)),))
        svc = _loaded(fault_plan=plan)
        h = svc.submit("x", "permanova", grouping=GROUPING,
                       permutations=99, key=5)
        svc.run()
        assert h.status == "done"
        assert h.result.p_value == ref
        assert svc.metrics.pool_sheds == 1
        assert svc.metrics.tile_failures["oom"] == 1
        # an IDLE session was shed; the active study survived
        assert "x" in svc.pool
        assert len(svc.pool) == 2

    def test_slow_tile_completes(self):
        ref = _reference_p(other="y")
        plan = FaultPlan(seed=0, specs=(
            FaultSpec("serve.tile", "slow", at=(1,), delay_s=0.02),))
        svc = _loaded(fault_plan=plan)
        h = svc.submit("x", "mantel", other="y", permutations=99, key=5)
        svc.run()
        assert h.status == "done"
        assert h.result.p_value == ref
        assert svc.metrics.retries == 0   # slow is not a failure

    def test_backoff_is_bounded_and_deterministic(self):
        from repro_torch.serve import RetryPolicy
        pol = RetryPolicy(base_s=0.01, multiplier=2.0, max_backoff_s=0.1,
                          jitter=0.5, seed=4)
        delays = [pol.backoff(f, "backoff:mantel", f) for f in
                  range(1, 12)]
        assert delays == [pol.backoff(f, "backoff:mantel", f)
                          for f in range(1, 12)]
        assert all(d <= 0.1 * 1.5 for d in delays)    # capped (+jitter)
        assert delays[0] < delays[3]                  # grows early


# --------------------------------------------------------------------------
# Watchdog escalation: stalled tiles re-enter the retry path
# --------------------------------------------------------------------------
class TestStallEscalation:
    def test_stalled_tile_escalates_and_recovers_bitwise(self):
        ref = _reference_p(other="y")
        plan = FaultPlan(seed=0, specs=(
            FaultSpec("serve.tile", "stall", at=(0,)),))
        svc = _loaded(fault_plan=plan)
        h = svc.submit("x", "mantel", other="y", permutations=99, key=5)
        svc.run()
        assert h.status == "done"
        assert h.result.p_value == ref
        assert svc.metrics.escalations == 1
        assert len(svc.scheduler.monitor.escalations) == 1
        rec = svc.scheduler.monitor.escalations[0]
        assert rec.aborted_open_step or rec.deadline_s < rec.elapsed_s
        # the aborted attempt never entered the scored step records —
        # only the tiles that actually completed are in the baseline
        assert len(svc.scheduler.monitor.records) == \
            svc.scheduler.tiles_run

    def test_stall_never_hangs_before_median(self):
        # a FIRST-tile stall has no straggler median to arm the
        # deadline — escalate() must fire anyway (regression: this hung)
        plan = FaultPlan(seed=0, specs=(
            FaultSpec("serve.tile", "stall", at=(0,)),))
        svc = _loaded(fault_plan=plan)
        h = svc.submit("x", "mantel", other="y", permutations=33, key=1)
        t0 = time.monotonic()
        svc.run()
        assert time.monotonic() - t0 < 60
        assert h.done


# --------------------------------------------------------------------------
# Circuit breaker: poison requests degrade instead of wedging the lane
# --------------------------------------------------------------------------
class TestCircuitBreaker:
    def test_persistent_failure_rejects_with_circuit_open(self):
        svc = _loaded(fault_plan=FaultPlan(seed=0, specs=(
            FaultSpec("serve.tile", "error", rate=1.0),)))
        h = svc.submit("x", "mantel", other="y", permutations=99, key=5)
        svc.run()
        assert h.status == "rejected"      # zero draws done: no envelope
        assert h.error.code == "circuit_open"
        assert svc.metrics.breaker_trips == 1
        assert svc.metrics.tile_failures["transient"] == 3  # k then trip

    def test_midflight_failure_degrades_with_envelope(self):
        # first tile succeeds, everything after fails: the request has
        # real draws, so it degrades to the partial envelope
        svc = _loaded(fault_plan=FaultPlan(seed=0, specs=(
            FaultSpec("serve.tile", "error", at=tuple(range(1, 200))),)))
        h = svc.submit("x", "mantel", other="y", permutations=99, key=5)
        svc.run()
        assert h.status == "degraded"
        assert h.error.code == "circuit_open"
        frame = h.partial()
        assert frame.draws_done == 16
        assert 0.0 < frame.p_lo <= frame.p_hi <= 1.0
        # the envelope brackets the fault-free answer
        ref = _reference_p(other="y")
        assert frame.p_lo <= ref <= frame.p_hi
        p = h.payload()
        assert p["status"] == "degraded"
        assert p["error"]["code"] == "circuit_open"
        assert p["progress"]["p_lo"] == frame.p_lo

    def test_breaker_isolates_lane_not_service(self):
        # the poisoned lane opens; a different method's lane is fine
        svc = _loaded(fault_plan=FaultPlan(seed=0, specs=(
            FaultSpec("serve.tile", "error", rate=1.0, max_fires=3),)))
        bad = svc.submit("x", "mantel", other="y", permutations=99, key=5)
        svc.run()
        assert bad.error.code == "circuit_open"
        good = svc.submit("x", "permanova", grouping=GROUPING,
                          permutations=49, key=6)
        svc.run()
        assert good.status == "done"


# --------------------------------------------------------------------------
# Compile faults at activation
# --------------------------------------------------------------------------
class TestCompileFaults:
    def test_transient_compile_retries_at_activation(self):
        ref = _reference_p(other="y")
        svc = _loaded(fault_plan=FaultPlan(seed=0, specs=(
            FaultSpec("serve.hoist", "compile", rate=1.0, max_fires=1),)))
        h = svc.submit("x", "mantel", other="y", permutations=99, key=5)
        svc.run()
        assert h.status == "done"
        assert h.result.p_value == ref
        assert svc.metrics.faults["serve.hoist:compile"] == 1

    def test_persistent_compile_becomes_unavailable(self):
        svc = _loaded(fault_plan=FaultPlan(seed=0, specs=(
            FaultSpec("serve.hoist", "compile", rate=1.0),)))
        h = svc.submit("x", "mantel", other="y", permutations=99, key=5)
        svc.run()
        assert h.status == "rejected"
        assert h.error.code == "unavailable"


# --------------------------------------------------------------------------
# The eviction / re-upload race (stale generations)
# --------------------------------------------------------------------------
class TestStaleGeneration:
    def _midflight(self, svc, k=99):
        h1 = svc.submit("x", "mantel", other="y", permutations=k, key=5)
        h2 = svc.submit("x", "mantel", other="y", permutations=k, key=6)
        while svc.scheduler.tiles_run < 1:
            svc.step()
        assert not h1.done and not h2.done          # genuinely mid-tile
        return h1, h2

    def test_reupload_mid_tile_rejects_inflight_structurally(self):
        svc = _loaded()
        h1, h2 = self._midflight(svc)
        gen0 = svc.pool.get("x").generation
        svc.upload("x", features=_features(24, 6, seed=99))
        for h in (h1, h2):
            assert h.status == "rejected"
            assert h.error.code == "stale_generation"
            assert h.error.detail["study_id"] == "x"
        assert svc.pool.get("x").generation == gen0 + 1
        assert svc.metrics.stale_terminations == 2
        svc.run()                                   # no residue, no crash
        # the lane died with its generation
        assert not svc.scheduler.lanes
        # new submissions run against the new data
        h3 = svc.submit("x", "mantel", other="y", permutations=33, key=7)
        svc.run()
        assert h3.status == "done"

    def test_reupload_of_operand_study_is_also_stale(self):
        # the OTHER side of a mantel lane going stale must invalidate too
        svc = _loaded()
        h1, _ = self._midflight(svc)
        svc.upload("y", features=_features(24, 5, seed=77))
        assert h1.status == "rejected"
        assert h1.error.code == "stale_generation"

    def test_injected_pool_eviction_race(self):
        plan = FaultPlan(seed=0, specs=(
            FaultSpec("serve.pool", "evict", at=(2,), max_fires=1),))
        svc = _loaded(fault_plan=plan)
        h = svc.submit("x", "mantel", other="y", permutations=99, key=5)
        svc.run()
        assert h.done                               # terminated, not hung
        assert h.status == "rejected"
        assert h.error.code == "stale_generation"
        assert "x" not in svc.pool                  # really evicted
        rep = serve_report(svc)
        assert rep["faults"]["injected"]["serve.pool:evict"] == 1


# --------------------------------------------------------------------------
# Deadlines and cancellation
# --------------------------------------------------------------------------
class TestDeadlinesAndCancel:
    def test_active_deadline_cancels_cooperatively(self):
        svc = _loaded()
        h = svc.submit("x", "mantel", other="y", permutations=999, key=5,
                       timeout_s=3600.0)
        while svc.scheduler.tiles_run < 2:
            svc.step()
        h.deadline = time.monotonic() - 1.0         # lapse it, precisely
        svc.run()
        assert h.status == "degraded"               # draws done: envelope
        assert h.error.code == "deadline"
        assert h.partial().draws_done >= 32
        ref = _reference_p(other="y", permutations=999)
        assert h.partial().p_lo <= ref <= h.partial().p_hi

    def test_cancel_queued_request(self):
        svc = _loaded(max_active=1)
        svc.submit("x", "mantel", other="y", permutations=99, key=5)
        h2 = svc.submit("x", "permanova", grouping=GROUPING,
                        permutations=99, key=6)
        assert svc.cancel(h2) is True
        assert h2.status == "rejected"
        assert h2.error.code == "cancelled"
        assert svc.cancel(h2) is False              # already terminal
        svc.run()

    def test_cancel_active_request_degrades(self):
        svc = _loaded()
        h = svc.submit("x", "mantel", other="y", permutations=999, key=5)
        while svc.scheduler.tiles_run < 1:
            svc.step()
        assert svc.cancel(h) is True
        assert h.status == "degraded"
        assert h.error.code == "cancelled"
        svc.run()


# --------------------------------------------------------------------------
# Journal recovery: crash, rebuild, resume — bitwise
# --------------------------------------------------------------------------
class TestJournalRecovery:
    KS = (99, 49, 33)                                # ΣK=181, B=16 → 12

    def _reference(self):
        s = _loaded()
        hs = [s.submit("x", "mantel", other="y", permutations=k,
                       key=10 + i) for i, k in enumerate(self.KS)]
        s.run()
        return [h.result.p_value for h in hs]

    def test_recover_resumes_bitwise_without_rehoisting(self, tmp_path):
        ref = self._reference()
        path = str(tmp_path / "serve.journal")
        svc = _loaded(journal_path=path)
        for i, k in enumerate(self.KS):
            svc.submit("x", "mantel", other="y", permutations=k,
                       key=10 + i)
        t = 4                                        # crash after 4 tiles
        while svc.scheduler.tiles_run < t:
            svc.step()
        pool = svc.pool                              # sessions survive
        svc.journal.close()                          # the "crash"
        hoists_before = {
            sid: dict(pool._sessions[sid].cache.misses)
            for sid in pool.studies()}

        svc2, handles = AnalysisService.recover(
            path, pool=pool,
            config=ServeConfig(timeout_s=None, auto_tune=False,
                               batch_size=16, device="cpu"))
        assert len(handles) == 3                     # none were terminal
        svc2.run()
        got = [handles[rid].result.p_value
               for rid in sorted(handles, key=lambda r: int(r[1:]))]
        assert got == ref                            # bitwise, post-crash
        # completed blocks were NOT re-run: exactly the remaining tiles
        total = math.ceil(sum(self.KS) / 16)
        assert svc2.scheduler.tiles_run == total - t
        # ... and NOTHING re-hoisted (the counters stay pinned)
        for sid in pool.studies():
            assert dict(pool._sessions[sid].cache.misses) == \
                hoists_before[sid]
        assert svc2.metrics.resumes == 1             # only r1 had progress
        assert svc2.metrics.resumed_rows == t * 16

    def test_second_recovery_is_empty(self, tmp_path):
        path = str(tmp_path / "serve.journal")
        svc = _loaded(journal_path=path)
        svc.submit("x", "mantel", other="y", permutations=33, key=5)
        while svc.scheduler.tiles_run < 1:
            svc.step()
        pool = svc.pool
        svc.journal.close()
        svc2, handles = AnalysisService.recover(
            path, pool=pool, config=ServeConfig(device="cpu"))
        assert len(handles) == 1
        svc2.run()
        svc2.journal.close()
        # every request now has a terminal record — nothing to resume
        svc3, handles3 = AnalysisService.recover(
            path, pool=pool, config=ServeConfig(device="cpu"))
        assert handles3 == {}

    def test_terminal_requests_not_resubmitted(self, tmp_path):
        path = str(tmp_path / "serve.journal")
        svc = _loaded(journal_path=path)
        h = svc.submit("x", "mantel", other="y", permutations=33, key=5)
        svc.run()                                    # finishes cleanly
        assert h.status == "done"
        svc.journal.close()
        svc2, handles = AnalysisService.recover(
            path, pool=svc.pool, config=ServeConfig(device="cpu"))
        assert handles == {}


# --------------------------------------------------------------------------
# The chaos soak: the CI gate, in-miniature
# --------------------------------------------------------------------------
class TestChaosSoak:
    def _requests(self, svc):
        return [
            svc.submit("x", "mantel", other="y", permutations=49, key=0),
            svc.submit("x", "mantel", other="y", permutations=33, key=1),
            svc.submit("x", "permanova", grouping=GROUPING,
                       permutations=49, key=2),
            svc.submit("x", "anosim", grouping=GROUPING,
                       permutations=33, key=3),
        ]

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_all_terminate_and_completed_are_bitwise(self, seed):
        clean = _loaded()
        ref = {h.request_id: h for h in self._requests(clean)}
        clean.run()
        svc = _loaded(fault_plan=FaultPlan.chaos(
            seed=seed, tile_error=0.15, oom=0.05, nan=0.05, slow=0.0,
            compile_rate=0.3))
        handles = self._requests(svc)
        t0 = time.monotonic()
        svc.run()
        assert time.monotonic() - t0 < 120
        for h in handles:
            assert h.done, f"request {h.request_id} never terminated"
            assert h.status in ("done", "degraded", "rejected",
                                "timed_out")
            if h.status == "done":
                assert h.result.p_value == \
                    ref[h.request_id].result.p_value
        # amplification stays bounded even at aggressive rates
        assert svc.metrics.retry_amplification <= 2.0
        rep = serve_report(svc)
        assert rep["faults"]["plan"]["seed"] == seed
        assert rep["faults"]["retries"] == svc.metrics.retries


# --------------------------------------------------------------------------
# Payload uniformity + zero-cost-when-disabled
# --------------------------------------------------------------------------
class TestSurface:
    def test_payload_shape_uniform_across_outcomes(self):
        clean = _loaded()
        done = clean.submit("x", "permanova", grouping=GROUPING,
                            permutations=49, key=1)
        with pytest.raises(Rejected):
            clean.submit("x", "nonsense")
        bad = clean.submit("x", "mantel", other="missing", permutations=9)
        clean.run()
        queued = clean.submit("x", "anosim", grouping=GROUPING)
        faulty = _loaded(fault_plan=FaultPlan(seed=0, specs=(
            FaultSpec("serve.tile", "error", at=tuple(range(1, 200))),)))
        degraded = faulty.submit("x", "mantel", other="y",
                                 permutations=99, key=5)
        faulty.run()
        statuses = {}
        for h in (done, degraded, bad, queued):
            p = h.payload()
            assert set(p.keys()) == PAYLOAD_KEYS, h.status
            statuses[h.status] = p
        assert statuses["done"]["error"] is None
        assert statuses["done"]["result"]["p_value"] is not None
        assert statuses["degraded"]["error"]["code"] == "circuit_open"
        assert statuses["degraded"]["progress"]["p_hi"] <= 1.0
        assert statuses["degraded"]["result"] is None
        assert statuses["rejected"]["error"]["code"] == "unknown_study"
        assert statuses["queued"]["result"] is None

    def test_disabled_plane_is_absent(self):
        svc = _loaded()
        assert svc.injector is None
        assert svc.scheduler.injector is None
        assert svc.journal is None
        h = svc.submit("x", "mantel", other="y", permutations=33, key=5)
        svc.run()
        assert h.status == "done"
        rep = serve_report(svc)
        assert "plan" not in rep["faults"]
        assert rep["faults"]["retries"] == 0
        assert rep["faults"]["retry_amplification"] == 0.0

    def test_degraded_counts_separately_from_completed(self):
        svc = _loaded(fault_plan=FaultPlan(seed=0, specs=(
            FaultSpec("serve.tile", "error", at=tuple(range(1, 200))),)))
        svc.submit("x", "mantel", other="y", permutations=99, key=5)
        svc.run()
        g = serve_report(svc)["gauges"]
        assert g["degraded"] == 1
        assert g["completed"] == 0


# --------------------------------------------------------------------------
# The port against the reference: the same schedule, the same journal bytes
# --------------------------------------------------------------------------
def _spec_plans(seed):
    """The chaos plan with every site armed, as the port's and the
    reference's plan objects."""
    rates = dict(tile_error=0.1, oom=0.03, nan=0.03, slow=0.02,
                 compile_rate=0.2, evict=0.05)
    port = FaultPlan.chaos(seed=seed, **rates)
    ref = JaxPlan.chaos(seed=seed, **rates)
    pinned = (("serve.tile", "stall", (3, 500)),
              ("serve.hoist", "compile", (7,)))
    port = FaultPlan(seed=seed, specs=port.specs + tuple(
        FaultSpec(site, kind, at=at) for site, kind, at in pinned))
    ref = JaxPlan(seed=seed, specs=ref.specs + tuple(
        JaxSpec(site, kind, at=at) for site, kind, at in pinned))
    return port, ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedule_fires_at_the_references_invocations(seed):
    """For a seed, every site fires the same kinds at the same
    invocations as the reference, over 1000 invocations a site."""
    port_plan, ref_plan = _spec_plans(seed)
    port, ref = FaultInjector(port_plan), JaxInjector(ref_plan)
    for _ in range(1000):
        for site in SITES:
            got = [spec.kind for spec in port.poll(site)]
            want = [spec.kind for spec in ref.poll(site)]
            assert got == want
    assert [(e.site, e.kind, e.index) for e in port.fires] == \
        [(e.site, e.kind, e.index) for e in ref.fires]
    assert port.summary() == ref.summary()
    assert len(port.fires) > 100


def test_journal_lines_match_the_reference(tmp_path):
    """The journal's encoded lines are the reference's, byte for byte,
    for the records the service writes."""
    records = [
        {"t": "submit", "rid": "r1", "study": "x", "method": "mantel",
         "permutations": 999, "key": 5, "alternative": None,
         "grouping": None, "other": "y", "control": None,
         "dimensions": None, "pcoa_method": "fsvd"},
        {"t": "submit", "rid": "r2", "study": "x", "method": "anosim",
         "permutations": 49, "key": {"generator": "00ff10"},
         "alternative": "greater", "grouping": [0, 1, 0, 1],
         "other": None, "control": None, "dimensions": 4,
         "pcoa_method": "fsvd"},
        {"t": "progress", "rid": "r1", "cursor": 57, "count": 3},
        {"t": "terminal", "rid": "r1", "status": "done"},
        {"t": "terminal", "rid": "r2", "status": "resubmitted",
         "as": "r7", "note": "unicode: µ ü"},
    ]
    for rec in records:
        assert _encode(rec) == jax_encode(rec)
    path = str(tmp_path / "j.log")
    with Journal(path) as j:
        for rec in records:
            j.append(rec)
    assert list(replay(path)) == list(jax_replay(path)) == records
    assert unit_hash(3, "serve.tile:0", 17) == \
        jax_unit_hash(3, "serve.tile:0", 17)


def test_generator_keys_survive_recovery(tmp_path):
    """A request keyed by a ``torch.Generator`` journals its state at
    submit; recovery rebuilds it, so the replayed request draws the same
    orders: bitwise the uninterrupted run."""
    import torch
    gen = torch.Generator().manual_seed(1234)
    ref = _loaded()
    hr = ref.submit("x", "mantel", other="y", permutations=99,
                    key=torch.Generator().manual_seed(1234))
    ref.run()
    path = str(tmp_path / "serve.journal")
    svc = _loaded(journal_path=path)
    h = svc.submit("x", "mantel", other="y", permutations=99, key=gen)
    gen.manual_seed(99)                    # the caller's generator moves on
    while svc.scheduler.tiles_run < 2:
        svc.step()
    assert not h.done
    svc.journal.close()
    svc2, handles = AnalysisService.recover(
        path, pool=svc.pool, config=ServeConfig(
            timeout_s=None, auto_tune=False, batch_size=16, device="cpu"))
    svc2.run()
    (got,) = handles.values()
    assert got.status == "done"
    assert got.result.p_value == hr.result.p_value
    assert svc2.scheduler.tiles_run == math.ceil(99 / 16) - 2
