"""The grouping cells on the card: the HMP cell's PERMANOVA runs over the
condensed operator, five ``condensed_matvec`` launches a tile and no n x n
square, and at a size a test run holds the port keeps within both cells'
limits while the reference one precision below fp32 in its place does not.

``PYTHONPATH=src python -m pytest -q -m card perfbench/tests`` on a card.
"""

from pathlib import Path

import pytest

from perfbench import harness, manifest

ROOT = Path(__file__).resolve().parents[2]
BATTERY = "square-16k.battery"
SITES = "hmp-v35-bodysite.group-significance"
SIZES = {BATTERY: {"n": 2048}, SITES: {"n": 2048}}


def cell(workload):
    return manifest.resolve(manifest.load_json(ROOT / "BENCHMARK.json"),
                            workload)


@pytest.mark.card
def test_the_sites_permanova_runs_over_the_condensed_operator(card):
    from repro_torch.kernels.condensed_matvec import KMAX
    from repro_torch.stats.engine import WORKSPACE_BATCH
    sites = cell(SITES)
    bench = harness.Bench(sites, 2**31 + 21, card)      # the cell's size
    bench.study(bench.plan.warmup_key)
    out = bench.study(bench.plan.key(0))["permanova"]
    tiles = -(-999 // WORKSPACE_BATCH)
    per_tile = -(-WORKSPACE_BATCH * sites.config["sites"] // KMAX)
    assert per_tile == 5
    # the observed statistic's product, then each tile's
    assert out["launches"]["condensed_matvec"] == 1 + tiles * per_tile
    assert not any(name.startswith("center") for name in out["launches"])
    assert out["square"] is False


@pytest.mark.card
@pytest.mark.parametrize("workload", [BATTERY, SITES])
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2])
def test_the_grouping_control_on_the_card(workload, seed, card):
    bench = harness.Bench(cell(workload), seed, card, SIZES[workload])
    limits = bench.cell.limits
    bench.study(bench.plan.warmup_key)
    studies, failed, _ = bench.window(0.0, count=3)
    assert not failed
    sound = harness.compare(bench.judge(studies), limits)
    control = harness.compare(bench.judge(studies, control=True), limits)
    assert all(harness.passed(c) for c in sound.values()), sound
    assert not all(harness.passed(c) for c in control.values()), control
