"""Port parity of the measured half: ``repro_torch.obs.probe`` and
``repro_torch.obs.drift`` against ``repro.obs.probe`` and ``repro.obs.drift``.

The cases of ``tests/test_probe.py`` that have a counterpart: a record's
argument and output bytes equal the reference's for the same operands,
the memo by geometry, the stream pass's exact 8 bytes an element, the
drift verdicts tight at (n = 2048, B = 32) and an 11x blown count
rejected, the reconciled entry points and verdict keys, a Workspace
report's ``measured`` and ``drift`` sections, and ``calibrate(mode=
"probe")``. The reference's HLO-text cases have no counterpart (the port
has no HLO); in their place the dispatch counter's conventions are
checked on tiny programs with known answers. Every probe here runs on the
CPU at the tests' small sizes; ``tests/test_torch_cuda.py`` probes the
card.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.api.config import ExecConfig as JaxExecConfig
from repro.api.workspace import Workspace as JaxWorkspace
from repro.obs import ObsConfig as JaxObsConfig
from repro.obs import drift as jax_drift
from repro.obs import probe as jax_probe
from repro.tune.budget import calibrate as jax_calibrate
from repro_torch.api import ExecConfig, Workspace
from repro_torch.core import random_distance_matrix
from repro_torch.core.mantel import MantelStatistic
from repro_torch.kernels import _build
from repro_torch.obs import ObsConfig, drift, probe
from repro_torch.obs.compile import sentinel
from repro_torch.obs.trace import current_obs
from repro_torch.tune.budget import calibrate, detect_budget, stream_pass

CPU = "cpu"


# --------------------------------------------------------------------------
# The dispatch counter's conventions, on programs with known answers
# --------------------------------------------------------------------------
def test_views_and_allocation_are_free():
    x = torch.ones((4, 6))
    rec = probe.probe_call(
        "toy.views", lambda a: (a.view(24).view(6, 4).t()[1:, 2],
                                torch.empty((100,))), (x,))
    assert rec.bytes_corrected == 0.0
    assert rec.argument_bytes == 96


def test_elementwise_op_reads_operands_and_writes_its_output():
    a, b = torch.ones((10,)), torch.ones((10,))
    rec = probe.probe_call("toy.add", torch.add, (a, b))
    assert rec.bytes_corrected == 3 * 40
    assert rec.output_bytes == 40
    assert rec.flops == 0.0


def test_index_select_is_charged_its_slice_not_its_source():
    src = torch.arange(1000, dtype=torch.float32)
    idx = torch.tensor([3, 7, 9, 11, 500], dtype=torch.int64)
    rec = probe.probe_call("toy.gather",
                           lambda s, i: torch.index_select(s, 0, i),
                           (src, idx))
    assert rec.bytes_corrected == 2 * 5 * 4
    rec = probe.probe_call("toy.scatter",
                           lambda s, i: s.clone().index_put_(
                               (i,), torch.zeros(5)), (src, idx))
    # the clone reads and writes the source; the scatter moves 5 floats
    assert rec.bytes_corrected == 2 * 4000 + 2 * 5 * 4 + 20


def test_copy_reads_its_source_and_writes_its_destination():
    src, dst = torch.ones((8,)), torch.zeros((16,))
    rec = probe.probe_call("toy.copy", lambda s, d: d[:8].copy_(s),
                           (src, dst))
    assert rec.bytes_corrected == 2 * 32


def test_matmul_flops_come_from_the_flop_counter():
    a, b = torch.ones((4, 8)), torch.ones((8, 3))
    rec = probe.probe_call("toy.mm", torch.matmul, (a, b))
    assert rec.flops == 2 * 4 * 8 * 3
    assert rec.bytes_corrected == 4 * (32 + 24 + 12)


def test_cpu_peak_counts_live_temporaries():
    def fn(x):
        t = x * 2.0                  # a 400-byte temporary ...
        u = t + 1.0                  # ... live beside this one
        del t
        return u.sum()

    x = torch.ones((100,))
    rec = probe.probe_call("toy.peak", fn, (x,))
    assert rec.argument_bytes == 400 and rec.output_bytes == 4
    assert rec.peak_bytes == 3 * 400             # x, t and u at once
    assert rec.temp_bytes == rec.peak_bytes - 404


def test_a_declared_launch_is_added_once_and_launches_are_restored():
    def fn(x):
        _build.launches["permute_reduce"] += 1
        _build.recorder("permute_reduce", 1000.0, 50.0)
        return x + 1.0

    before = dict(_build.launches)
    rec = probe.probe_call("toy.launch", fn, (torch.ones((4,)),))
    assert rec.bytes_corrected == 1000.0 + 2 * 16
    assert rec.flops == 50.0
    assert rec.launches == {"permute_reduce": {"count": 1, "bytes": 1000.0,
                                               "flops": 50.0}}
    assert rec.scan_trips == {}
    assert _build.launches == before and _build.recorder is None


def test_a_launch_that_declares_nothing_fails_the_probe():
    def fn(x):
        _build.launches["symhollow"] += 1
        return x

    before = dict(_build.launches)
    with pytest.raises(RuntimeError, match="declared no cost"):
        probe.probe_call("toy.undeclared", fn, (torch.ones((4,)),))
    assert _build.launches == before and _build.recorder is None


def test_a_probe_notes_no_call_and_joins_no_session():
    from repro_torch.obs.report import ObsSession

    session = ObsSession()
    base = sentinel.snapshot()
    with session.span("outer"):
        probe.probe_call("toy.silent", lambda a: current_obs().span("x"),
                         (torch.ones((2,)),))
        probe.clear_probe_cache()
        probe.probe_permute_reduce(16, batch=4, device=CPU)
        assert current_obs() is session
    assert sentinel.snapshot() == base
    assert session.ledger.entries == []
    assert [s["name"] for s in session.tracer.to_dicts()] == ["outer"]
    assert not session.tracer.to_dicts()[0].get("children")


# --------------------------------------------------------------------------
# Entry-point probes against the reference's records
# --------------------------------------------------------------------------
def test_probe_permute_reduce_record_fields():
    rec = probe.probe_permute_reduce(96, batch=8, device=CPU)
    want = jax_probe.probe_permute_reduce(96, batch=8)
    assert rec.name == want.name == "kernels.permute_reduce"
    assert rec.backend == "cpu"
    m = 96 * 95 // 2
    assert rec.argument_bytes == want.argument_bytes == \
        4 * m + 4 * m + 4 * 8 * 96 + 2 * 4 * m
    assert rec.output_bytes == want.output_bytes == 4 * 8
    assert rec.bytes_corrected >= rec.argument_bytes + rec.output_bytes
    assert rec.bytes_corrected == rec.bytes_accessed
    assert rec.peak_bytes >= rec.argument_bytes
    assert rec.flops > 0
    d = rec.to_dict()
    json.dumps(d)
    assert d["params"]["n"] == want.params["n"] == 96
    assert set(want.to_dict()) <= set(d)


def test_probe_memoizes_by_geometry():
    probe.clear_probe_cache()
    r1 = probe.probe_permute_reduce(96, batch=8, device=CPU)
    r2 = probe.probe_permute_reduce(96, batch=8, device=CPU)
    assert r1 is r2
    r3 = probe.probe_permute_reduce(96, batch=16, device=CPU)
    assert r3 is not r1


def test_probe_stream_pass_counts_exactly_two_passes():
    n = 1 << 20
    rec = probe.probe_stream_pass(n, device=CPU)
    assert rec.bytes_corrected == 2 * 4 * n
    assert rec.bytes_corrected == jax_probe.probe_stream_pass(n) \
        .bytes_corrected
    assert rec.scan_trips == {}
    x = torch.ones((8,))
    assert torch.equal(stream_pass(x), x * 2.0)


def test_probe_panel_stats_and_center_matvec_records():
    panel = probe.probe_panel_stats(96, 24, device=CPU)
    want = jax_probe.probe_panel_stats(96, 24)
    assert panel.name == want.name
    assert panel.argument_bytes == want.argument_bytes == 4 * (96 * 24) * 2
    assert panel.output_bytes == 4 * (96 * 96 + 2 * 96)
    assert panel.params["block"] == want.params["block"] == 96
    mv = probe.probe_center_matvec(96, k=10, device=CPU)
    assert mv.name == "kernels.center_matvec"
    assert mv.argument_bytes == 4 * (96 * 96 + 96 * 10 + 96 + 1)
    assert mv.output_bytes == 4 * 96 * 10
    assert mv.flops >= 2 * 96 * 96 * 10
    for v in drift.DriftSentinel().check_panel(panel) + \
            drift.DriftSentinel().check_center_matvec(mv):
        assert v.within, v


@pytest.mark.parametrize("metric", ["euclidean", "cityblock", "canberra",
                                    "braycurtis", "jaccard"])
def test_plain_panel_lies_in_its_envelope_for_every_metric(metric):
    rec = probe.probe_panel_stats(200, 150, block=64, metric=metric,
                                  device=CPU)
    for v in drift.DriftSentinel(backend="cpu").check_panel(rec):
        assert v.within, v


def test_probe_statistic_and_matfree_solve():
    d = random_distance_matrix(0, 24, device=CPU).data
    recs = probe.probe_statistic(MantelStatistic(d, d, 24), batch=8,
                                 device=CPU)
    assert set(recs) == {"stats.engine.hoist_and_observe",
                         "stats.engine.tile"}
    assert recs["stats.engine.tile"].params == {
        "stat": "MantelStatistic", "n": 24, "batch": 8}
    assert recs["stats.engine.tile"].bytes_corrected > 0
    ws = Workspace(d, config=ExecConfig(device=CPU))
    op = ws.operator()
    rec = probe.probe_pcoa_matfree(op, k=3, device=CPU)
    assert rec.name == "pcoa.fsvd_matfree"
    assert rec.params["operator"] == "CenteredGramOperator"
    assert rec.flops > 0 and rec.output_bytes == 4 * (3 + 24 * 3)
    assert rec.argument_bytes == 4 * (24 * 24 + 24 + 1 + 24 * 13)
    elsewhere = dataclasses.replace(op, row_means=op.row_means.to("meta"))
    with pytest.raises(ValueError, match="lies on"):
        probe.probe_pcoa_matfree(elsewhere, k=3, device=CPU)


# --------------------------------------------------------------------------
# Drift: tight at the acceptance geometry, blown counts rejected
# --------------------------------------------------------------------------
def test_drift_permute_reduce_tight_at_2048():
    rec = probe.probe_permute_reduce(2048, batch=32, device=CPU)
    verdicts = drift.DriftSentinel(backend="cpu").check_permute_reduce(rec)
    assert {v.quantity for v in verdicts} == {"bytes", "peak"}
    for v in verdicts:
        assert v.within, v
    b = next(v for v in verdicts if v.quantity == "bytes")
    assert b.regime == "plain-chunked"
    # the closed form a chunk, c(24 + 20S + 148B) over 32 chunks of 65536,
    # the padding copies of ys, ii and jj, and ~91 bytes an order element
    # for the plain inverse
    m = 2048 * 2047 // 2
    eff = (32 * 65536 * (24 + 20 + 148 * 32) + 12 * (m + 32 * 65536)
           + 91 * 32 * 2048)
    assert 0.99 * eff <= rec.bytes_corrected <= 1.01 * eff
    assert b.ratio == pytest.approx(rec.bytes_corrected / (
        4 * 32 * (2048 * 2047 // 2 * (1 + 3 / 32) + 2048)))


def test_drift_rejects_square_gather_class_blowup():
    rec = probe.probe_permute_reduce(2048, batch=32, device=CPU)
    blown = probe.ProbeRecord(
        name=rec.name, backend=rec.backend, flops=rec.flops,
        bytes_accessed=rec.bytes_accessed,
        bytes_corrected=11.0 * rec.bytes_corrected,
        peak_bytes=rec.peak_bytes, argument_bytes=rec.argument_bytes,
        output_bytes=rec.output_bytes, temp_bytes=rec.temp_bytes,
        scan_trips=rec.scan_trips, params=rec.params)
    verdicts = drift.DriftSentinel(backend="cpu").check_permute_reduce(blown)
    assert not all(v.within for v in verdicts)


def test_drift_judges_a_record_by_the_device_it_ran_on():
    rec = probe.probe_stream_pass(1 << 10, device=CPU)
    card = dataclasses.replace(rec, backend="cuda")
    assert drift.DriftSentinel().slack_for("cuda") == (0.99, 1.01)
    assert drift.reconcile({rec.name: card})["slack"] == [0.99, 1.01]
    with pytest.raises(ValueError, match="cannot judge"):
        drift.DriftSentinel(backend="cpu").reconcile({rec.name: card})


def test_reconcile_full_record_set_within_tolerance():
    recs = [probe.probe_permute_reduce(96, batch=8, device=CPU),
            probe.probe_panel_stats(96, 24, device=CPU),
            probe.probe_stream_pass(1 << 20, device=CPU)]
    doc = drift.reconcile({r.name: r for r in recs})
    want = jax_drift.reconcile({r.name: r for r in [
        jax_probe.probe_permute_reduce(96, batch=8),
        jax_probe.probe_panel_stats(96, 24),
        jax_probe.probe_stream_pass(1 << 20)]})
    assert doc["within_tolerance"] is True
    assert doc["backend"] == want["backend"] == "cpu"
    names = {v["name"] for v in doc["verdicts"]}
    assert names == {v["name"] for v in want["verdicts"]} == {
        "kernels.permute_reduce", "dist.panel_stats", "tune.stream_pass"}
    assert set(doc) == set(want)
    assert {k for v in doc["verdicts"] for k in v} == \
        {k for v in want["verdicts"] for k in v}
    assert [(v["name"], v["quantity"]) for v in doc["verdicts"]] == \
        [(v["name"], v["quantity"]) for v in want["verdicts"]]
    json.dumps(doc)


def _card_record(name, params, nbytes, argument_bytes, output_bytes):
    return probe.ProbeRecord(
        name=name, backend="cuda", flops=0.0, bytes_accessed=nbytes,
        bytes_corrected=nbytes, peak_bytes=argument_bytes + output_bytes,
        argument_bytes=argument_bytes, output_bytes=output_bytes,
        temp_bytes=0, scan_trips={}, params=params)


@pytest.mark.parametrize("program", ["permute_reduce", "panel",
                                     "sparse_panel", "center_matvec"])
def test_card_regimes_take_the_launches_declared_costs(program):
    """A card record whose bytes are its launches' declared costs (the
    launch modules' ``*_cost`` at the record's geometry) plus the aten ops
    around them is within every band; 2% more bytes is not."""
    from repro_torch.kernels.center_matvec import center_matvec_cost
    from repro_torch.kernels.pairwise import (pairwise_cost, sparse_cost,
                                              sparse_rows)
    from repro_torch.kernels.permute_reduce import tile_cost

    sentinel = drift.DriftSentinel(backend="cuda")
    n = 16384
    if program == "permute_reduce":
        m, b, s = n * (n - 1) // 2, 32, 1
        # a 264-block grid, the permutation check and the concatenations
        nbytes = tile_cost(n, s, b, 264)[0] + 4 * b + 16 * s * b
        rec = _card_record("kernels.permute_reduce", {
            "n": n, "batch": b, "s": s, "chunk": None,
            "perms_per_launch": b}, nbytes, 4 * m * (1 + s) + 4 * b * n,
            4 * s * b)
        check = sentinel.check_permute_reduce
    elif program == "panel":
        d, b = 2048, 256
        nbytes = pairwise_cost(b, n, d, 3)[0] + 20 * b * n + 8 * b
        rec = _card_record("dist.panel_stats", {
            "n": n, "d": d, "block": b, "metric": "braycurtis",
            "route": "dense"}, nbytes, 4 * (b + n) * d, 4 * b * (n + 2))
        check = sentinel.check_panel
    elif program == "sparse_panel":
        n, d, b, nnz, max_row = 4743, 45383, 256, 2733443, 754
        rows = sparse_rows(d, max_row)
        nbytes = sparse_cost(b, n, nnz, rows)[0] + 20 * b * n + 8 * b
        rec = _card_record("dist.panel_stats", {
            "n": n, "d": d, "block": b, "metric": "braycurtis",
            "route": "sparse", "nnz": nnz, "max_row": max_row,
            "rows": rows}, nbytes, 4 * n * d + 8 * nnz + 4 * (n + 1),
            4 * b * (n + 2))
        check = sentinel.check_panel
    else:
        k = 10
        nbytes = (center_matvec_cost(n, n, k)[0] + 8 * n * k + 4 * n
                  + 36 * k + 4)
        rec = _card_record("kernels.center_matvec", {"n": n, "k": k}, nbytes,
                           4 * (n * n + n * k + n + 1), 4 * n * k)
        check = sentinel.check_center_matvec
    verdicts = check(rec)
    assert {v.quantity for v in verdicts} == {"bytes", "peak"}
    for v in verdicts:
        assert v.within, v
    blown = dataclasses.replace(rec, bytes_corrected=1.02 * nbytes)
    assert not all(v.within for v in check(blown))


def _counts(seed, n=60, d=400, share=0.05):
    """An (n, d) table of integer counts, each entry nonzero with
    probability ``share``."""
    rng = np.random.default_rng(seed)
    return ((rng.random((n, d)) < share)
            * rng.integers(1, 40, (n, d))).astype(np.float32)


def test_sparse_feature_session_probes_the_sparse_panel():
    """A feature session on a table below ``SPARSE_SHARE`` probes one panel
    of the route its production takes: the sparse panel, judged by the
    sparse forms under the reference's verdict names."""
    from repro_torch.kernels.pairwise import sparse_rows

    x = _counts(11)
    ws = Workspace.from_features(x, config=ExecConfig(
        device=CPU, obs=ObsConfig(enabled=True)))
    ws.pcoa(dimensions=3)
    rep = ws.report()
    route = rep.meta["tiles"]["production_route"]
    assert route["route"] == "sparse"
    assert route["nnz"] == int((x != 0).sum())
    assert route["max_row"] == int((x != 0).sum(axis=1).max())
    params = rep.measured["dist.panel_stats"]["params"]
    assert params["route"] == "sparse"
    assert (params["nnz"], params["max_row"]) == (route["nnz"],
                                                  route["max_row"])
    assert params["rows"] == sparse_rows(400, route["max_row"])
    assert rep.drift_ok
    assert {v["regime"] for v in rep.drift["verdicts"]
            if v["name"] == "dist.panel_stats"} == {"plain-sparse"}
    jws = JaxWorkspace.from_features(x, config=JaxExecConfig(
        obs=JaxObsConfig(enabled=True)))
    jws.pcoa(dimensions=3)
    want = jws.report()
    assert set(rep.measured) == set(want.measured)
    assert [(v["name"], v["quantity"]) for v in rep.drift["verdicts"]] == \
        [(v["name"], v["quantity"]) for v in want.drift["verdicts"]]


@pytest.mark.parametrize("n, d, share, block", [
    (48, 400, 0.05, 48), (200, 1000, 0.02, 64), (130, 500, 0.1, 40),
    (5, 30, 0.1, 256)])
def test_plain_sparse_panel_lies_in_its_band(n, d, share, block):
    """The plain sparse panel's bytes lie between the closed form without
    and with the panel rows' own nonzeros, and its peak in its envelope."""
    nnz = int(n * d * share)
    max_row = max(int(1.6 * d * share), -(-nnz // n))
    rec = probe.probe_panel_stats(n, d, block=block, device=CPU, nnz=nnz,
                                  max_row=max_row)
    assert rec.params["route"] == "sparse"
    assert set(rec.launches) == set()
    verdicts = drift.DriftSentinel(backend="cpu").check_panel(rec)
    for v in verdicts:
        assert v.within and v.regime == "plain-sparse", v
    b = next(v for v in verdicts if v.quantity == "bytes")
    assert b.expected_lo / 0.95 <= rec.bytes_corrected \
        <= b.expected_hi / 1.05


# --------------------------------------------------------------------------
# The session front door
# --------------------------------------------------------------------------
def _session(probed: bool, jax: bool = False):
    rng = np.random.default_rng(7)
    x = rng.random((48, 12)).astype(np.float32) + .01
    groups = rng.integers(0, 3, 48)
    if jax:
        ws = JaxWorkspace.from_features(x, config=JaxExecConfig(
            obs=JaxObsConfig(enabled=True, probe=probed)))
        ws.permanova(groups, permutations=9)
    else:
        ws = Workspace.from_features(x, config=ExecConfig(
            device=CPU, obs=ObsConfig(enabled=True, probe=probed)))
        ws.permanova(groups, permutations=9,
                     orders=np.argsort(rng.random((9, 48)), axis=1))
    return ws


def _span_shape(spans):
    return [(s["name"], s.get("phase"), _span_shape(s.get("children", [])))
            for s in spans]


def test_workspace_report_measured_and_drift_sections():
    rep = _session(True).report()
    want = _session(True, jax=True).report()
    assert set(rep.measured) == set(want.measured) == {
        "kernels.permute_reduce", "dist.panel_stats", "pcoa.fsvd_matfree"}
    assert rep.drift["verdicts"] and rep.drift_ok
    assert rep.drift["backend"] == "cpu"
    assert [(v["name"], v["quantity"]) for v in rep.drift["verdicts"]] == \
        [(v["name"], v["quantity"]) for v in want.drift["verdicts"]]
    assert all(r["backend"] == "cpu" for r in rep.measured.values())
    json.dumps(rep.to_dict())

    off = _session(False).report()
    assert off.measured == {} and off.drift == {} and off.drift_ok
    assert _span_shape(off.spans) == _span_shape(rep.spans)
    assert off.ledger == rep.ledger
    assert off.cache == rep.cache
    # calls equal; ``programs`` counts signatures new to the process
    assert ({k: v["traces"] for k, v in off.compile.items()}
            == {k: v["traces"] for k, v in rep.compile.items()})


def test_report_leaves_the_session_as_it_found_it():
    ws = _session(True)
    ws.pcoa(dimensions=3)
    probe.clear_probe_cache()
    _build.launches["permute_reduce"] += 3      # nonzero counts survive
    launches = dict(_build.launches)
    cache = (dict(ws.cache.hits), dict(ws.cache.misses))
    snap = sentinel.snapshot()
    totals = ws.obs.ledger.totals()
    spans = ws.obs.tracer.to_dicts()
    for _ in range(2):                          # the second from the memo
        ws.report()
        assert _build.launches == launches
        assert (dict(ws.cache.hits), dict(ws.cache.misses)) == cache
        assert sentinel.snapshot() == snap
        assert ws.obs.ledger.totals() == totals
        assert _span_shape(ws.obs.tracer.to_dicts()) == _span_shape(spans)
    _build.launches["permute_reduce"] -= 3


def test_square_session_probes_the_center_matvec():
    d = random_distance_matrix(1, 32, device=CPU)
    ws = Workspace(d, config=ExecConfig(device=CPU,
                                        obs=ObsConfig(enabled=True)))
    ws.pcoa(dimensions=3)
    rep = ws.report()
    assert set(rep.measured) == {"kernels.permute_reduce",
                                 "kernels.center_matvec", "pcoa.fsvd_matfree"}
    assert rep.drift_ok
    assert rep.measured["kernels.permute_reduce"]["params"]["chunk"] == \
        rep.meta["tiles"]["permute_reduce_plain_chunk"]
    assert rep.measured["kernels.center_matvec"]["params"]["k"] == 10
    rows = probe.probe_table({n: probe.probe_center_matvec(32, device=CPU)
                              for n in ("kernels.center_matvec",)})
    assert len(rows) == 1 and rows[0].startswith("kernels.center_matvec")


# --------------------------------------------------------------------------
# calibrate(mode="probe")
# --------------------------------------------------------------------------
def test_calibrate_probe_mode_is_deterministic():
    base = detect_budget("cpu")
    b1 = calibrate(base, mode="probe", large=1 << 20)
    b2 = calibrate(base, mode="probe", large=1 << 20)
    assert b1.source == "probed"
    assert b1.bandwidth == b2.bandwidth
    assert b1.latency == base.latency
    # the pass moves exactly the modeled two fp32 an element, so probe
    # calibration reproduces the static bandwidth, as the reference's does
    assert b1.bandwidth == base.bandwidth
    assert b1.bandwidth == jax_calibrate(mode="probe",
                                         large=1 << 20).bandwidth
    with pytest.raises(ValueError):
        calibrate(base, mode="nonsense")
