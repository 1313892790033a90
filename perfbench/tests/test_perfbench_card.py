"""The control on the card at a size a test run holds: the port's answers
keep within the cells' limits, and the reference one precision below fp32
in the port's place does not.

``PYTHONPATH=src python -m pytest -q -m card perfbench/tests`` on a card;
the cells' own sizes are read by ``perfbench/readings.py --control``.
"""

from pathlib import Path

import pytest

from perfbench import harness, manifest

ROOT = Path(__file__).resolve().parents[2]
SIZES = {"square-16k.study": {"n": 2048},
         "features-hmp-v35.core-metrics": {"n": 2048}}


@pytest.mark.card
@pytest.mark.parametrize("workload", sorted(SIZES))
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_control_on_the_card(workload, seed, card):
    cell = manifest.resolve(manifest.load_json(ROOT / "BENCHMARK.json"),
                            workload)
    bench = harness.Bench(cell, seed, card, SIZES[workload])
    bench.study(bench.plan.warmup_key)
    studies, failed, _ = bench.window(0.0, count=4)
    assert not failed
    sound = harness.compare(bench.judge(studies), cell.limits)
    control = harness.compare(bench.judge(studies, control=True),
                              cell.limits)
    assert all(harness.passed(c) for c in sound.values()), sound
    assert not all(harness.passed(c) for c in control.values()), control
    assert control["eig_gap"]["value"] >= 3 * sound["eig_gap"]["value"]
