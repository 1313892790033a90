"""Whole runs at a tiny size on the CPU: the result line, the check, the
control and the planted faults.

Each run skips the harness's look for a card (``run_cell`` with
``device="cpu"``) and drives the rest: inputs from the seed, the warm-up,
the window, the reference's judgement. The port runs its plain versions.
"""

import json
import sys
import types
from pathlib import Path

import pytest
import torch

from perfbench import harness, manifest

ROOT = Path(__file__).resolve().parents[2]
SQUARE = "square-16k.study"
FEATURES = "features-hmp-v35.core-metrics"
TINY = {SQUARE: {"n": 48}, FEATURES: {"n": 48, "d": 512}}
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run(workload, trace=False, seed=2**31 + 3, seconds=0.2):
    return harness.run_cell(ROOT, workload, seed, seconds, trace, "cpu",
                            TINY[workload])


@pytest.mark.parametrize("workload", [SQUARE, FEATURES])
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_prints_the_contract_line(workload, trace):
    result = run(workload, trace)
    keys = [k for k in result if k != "breakdown"]
    assert keys == KEYS
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    names = set(result["metrics"])
    if trace:
        assert "pcoa_s.study" in names and "setup_s" not in names
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert names == {"setup_s", "study_s"}
    assert result["device"]["platform"] == "cpu"
    json.dumps(harness.finite(result))


def test_the_same_seed_gives_the_same_inputs_and_answers():
    cell = manifest.resolve(manifest.load_json(ROOT / "BENCHMARK.json"),
                            SQUARE)
    a, b = (harness.Bench(cell, 99, torch.device("cpu"), TINY[SQUARE])
            for _ in range(2))
    assert torch.equal(a.inputs["x"], b.inputs["x"])
    assert not torch.equal(a.inputs["x"], a.inputs["y"])
    out_a, out_b = a.study(a.plan.key(0)), b.study(b.plan.key(0))
    assert out_a["mantel"] == out_b["mantel"]


def test_main_refuses_when_jax_is_loaded(capsys, monkeypatch):
    """The process that prints the result looks at its own modules once
    the window has closed."""
    monkeypatch.setattr(harness, "check_device", lambda chips: None)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {"checks": {}})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    args = types.SimpleNamespace(workload=SQUARE, seed=1, seconds=1.0,
                                 trace=0)
    assert harness.main(ROOT, args, 0.0) == harness.EXIT_FORBIDDEN
    assert capsys.readouterr().out == ""


def test_main_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = types.SimpleNamespace(workload=SQUARE, seed=1, seconds=1.0,
                                 trace=0)
    assert harness.main(ROOT, args, 0.0) == harness.EXIT_NO_DEVICE
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("workload", [SQUARE, FEATURES])
def test_the_control_fails_the_limits(workload):
    """The reference one precision below fp32, in the program's place."""
    cell = manifest.resolve(manifest.load_json(ROOT / "BENCHMARK.json"),
                            workload)
    bench = harness.Bench(cell, 5, torch.device("cpu"),
                          {**TINY[workload], "n": 256})
    studies, failed, _ = bench.window(0.0, count=4)
    assert not failed
    sound = harness.compare(bench.judge(studies), cell.limits)
    control = harness.compare(bench.judge(studies, control=True),
                              cell.limits)
    assert all(harness.passed(c) for c in sound.values())
    assert not harness.passed(control["eig_gap"])


def fault_square_answer(monkeypatch):
    """The Mantel statistic altered where it is produced."""
    from repro_torch.stats import engine
    finish = engine.finish

    def altered(orig_stat, *args, **kwargs):
        return finish(orig_stat + 1e-3, *args, **kwargs)
    monkeypatch.setattr(engine, "finish", altered)


def fault_square_half_batch(monkeypatch):
    """Half of each tile of permutations left out, the rest standing in."""
    from repro_torch.stats import engine
    tile = engine.tile_statistics

    def half(stat, invariants, orders):
        kept = tile(stat, invariants, orders[: max(len(orders) // 2, 1)])
        return kept.repeat(2)[: len(orders)]
    monkeypatch.setattr(engine, "tile_statistics", half)


def fault_square_state(monkeypatch):
    """The solver's product returns its block unchanged."""
    from repro_torch.core.operators import CenteredGramOperator
    monkeypatch.setattr(CenteredGramOperator, "matvec", lambda self, x: x)


def fault_features_answer(monkeypatch):
    """A distance altered where the panel produces it."""
    from repro_torch.dist import driver
    panel = driver.pairwise_panel_op

    def altered(xi, x, metric):
        strip = panel(xi, x, metric)
        return strip * 1.001
    monkeypatch.setattr(driver, "pairwise_panel_op", altered)


def fault_features_half_batch(monkeypatch):
    """Half of each panel's rows left out."""
    from repro_torch.dist import driver
    panel = driver.pairwise_panel_op

    def half(xi, x, metric):
        strip = panel(xi, x, metric)
        strip[strip.shape[0] // 2:] = 0.0
        return strip
    monkeypatch.setattr(driver, "pairwise_panel_op", half)


def fault_features_state(monkeypatch):
    """The condensed operator's product returns its block unchanged."""
    from repro_torch.core.operators import CondensedCenteredGramOperator
    monkeypatch.setattr(CondensedCenteredGramOperator, "matvec",
                        lambda self, x: x)


# the exchange between chips is no fault these one-chip cells can have
FAULTS = [(SQUARE, fault_square_answer, "r_gap"),
          (SQUARE, fault_square_half_batch, "p_outside"),
          (SQUARE, fault_square_state, "eig_gap"),
          (FEATURES, fault_features_answer, "dist_gap"),
          (FEATURES, fault_features_half_batch, "dist_gap"),
          (FEATURES, fault_features_state, "eig_gap")]


@pytest.mark.parametrize("workload,plant,reading", FAULTS,
                         ids=[f.__name__ for _, f, _ in FAULTS])
def test_a_planted_fault_comes_out_not_correct(workload, plant, reading,
                                               monkeypatch):
    plant(monkeypatch)
    result = run(workload, seed=11)
    assert result["correct"] is False
    assert not harness.passed(result["checks"][reading])


def test_only_the_last_study_keeps_its_distances():
    """Every study but the window's last is cut to its summary before the
    next one starts, so the check holds one study's distances."""
    cell = manifest.resolve(manifest.load_json(ROOT / "BENCHMARK.json"),
                            FEATURES)
    bench = harness.Bench(cell, 8, torch.device("cpu"), TINY[FEATURES])
    studies, failed, _ = bench.window(0.0, count=3)
    kept = [s.outputs["production"]["condensed"] for s in studies]
    assert not failed and kept[0] is None and kept[1] is None
    assert kept[2].shape == (48 * 47 // 2,)
    assert all(s.outputs["pcoa"]["eigenvalues"] is not None for s in studies)
