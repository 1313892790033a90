"""The grouping tests on the benchmark (``square-16k.battery``,
``hmp-v35-bodysite.group-significance``): the port against the plain
references on seeded data at a small size on the CPU, the planted faults
the references must catch, the inputs maker, the work counts, and tiny
whole runs of both cells."""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness, manifest, traffic
from perfbench.reference.orders import permutation_orders

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
BATTERY = "square-16k.battery"
SITES = "hmp-v35-bodysite.group-significance"
TINY = {BATTERY: {"n": 48}, SITES: {"n": 48, "d": 512}}
#: unequal groups, shuffled over the samples
SIZES = (17, 29, 33, 41)
PERMUTATIONS = 19
KEYS = [2**31 + 101 + i for i in range(6)]


def module(kind, name):
    return manifest.load_module(BENCH / kind / f"{name}.py")


def limits(workload):
    return manifest.load_json(BENCH / "limits" / f"{workload}.json")["limits"]


def labels(seed=3):
    rng = np.random.default_rng(seed)
    return rng.permutation(np.repeat(np.arange(len(SIZES)), SIZES))


def square(points):
    d = torch.cdist(points.double(), points.double()).float()
    d = 0.5 * (d + d.T)
    d.fill_diagonal_(0.0)
    return d


def study_square(effect=0.4, seed=5, ties=False):
    """Euclidean distances of 8-dimensional points, each group's shifted
    by ``effect``; with ``ties``, rounded to halves, so many pairs tie."""
    gen = torch.Generator().manual_seed(seed)
    codes = labels()
    shift = torch.randn((len(SIZES), 8), generator=gen, dtype=torch.float64)
    points = torch.randn((codes.size, 8), generator=gen, dtype=torch.float64)
    d = square(points + effect * shift[torch.from_numpy(codes)])
    if ties:
        d = torch.round(2 * d) / 2
    return {"x": d, "labels": codes}


def study_table(seed=7):
    """Counts of 40 features, each group's samples drawn from a profile of
    its own."""
    gen = torch.Generator().manual_seed(seed)
    codes = labels()
    profiles = torch.rand((len(SIZES), 40), generator=gen) ** 4
    rows = profiles[torch.from_numpy(codes)] + 0.05
    table = torch.zeros((codes.size, 40))
    table.scatter_add_(1, torch.multinomial(rows, 300, replacement=True,
                                            generator=gen),
                       torch.ones((codes.size, 300)))
    return {"table": table, "labels": codes}


def run_test(test, inputs, args):
    """The port's ``test`` through a session on the CPU, one study a key,
    each with the reference's orders of that key passed in."""
    from repro_torch.api.config import ExecConfig
    from repro_torch.api.workspace import Workspace
    config = ExecConfig(device="cpu")
    studies = []
    for key in KEYS:
        ws = (Workspace(inputs["x"], config=config) if "matrix" in args
              else Workspace.from_features(inputs["table"], "braycurtis",
                                           config=config))
        n = ws.n
        orders = permutation_orders(key, PERMUTATIONS, n, "cpu")
        extra = ({"dimensions": args["dimensions"], "method": "fsvd"}
                 if test == "permdisp" else {})
        result = getattr(ws, test)(inputs["labels"], PERMUTATIONS,
                                   orders=orders, **extra)
        studies.append(harness.Study(key, {test: {
            "statistic": result.statistic, "p_value": result.p_value}}))
    return studies


def judge(test, inputs, args, workload, control=False):
    args = {**args, "grouping": "labels", "permutations": PERMUTATIONS,
            "checked_studies": len(KEYS)}
    studies = run_test(test, inputs, args)
    readings = module("reference", test).judge(
        test, inputs, args, studies, np.random.default_rng(0),
        limits(workload), control)
    return harness.compare(readings, limits(workload))


CASES = [
    ("permanova", study_square, {"matrix": "x"}, BATTERY),
    ("permanova", study_table, {"table": "table"}, SITES),
    ("anosim", lambda: study_square(ties=True), {"matrix": "x"}, BATTERY),
    ("permdisp", study_square, {"matrix": "x", "dimensions": 10}, BATTERY),
]
IDS = ["permanova-square", "permanova-operator", "anosim-ties", "permdisp"]


@pytest.mark.parametrize("test,data,args,workload", CASES, ids=IDS)
def test_the_port_keeps_within_the_references_limits(test, data, args,
                                                     workload):
    checks = judge(test, data(), args, workload)
    assert {f"{test}_gap", f"{test}_p_outside"} <= set(checks)
    assert all(harness.passed(c) for c in checks.values()), checks


def test_the_tied_study_ties_most_pairs():
    d = study_square(ties=True)["x"]
    upper = torch.ones(d.shape, dtype=torch.bool).triu_(1)
    assert torch.unique(d[upper]).numel() < d[upper].numel() / 100


def test_the_operator_form_builds_no_square():
    from repro_torch.api.config import ExecConfig
    from repro_torch.api.workspace import Workspace
    inputs = study_table()
    ws = Workspace.from_features(inputs["table"], "braycurtis",
                                 config=ExecConfig(device="cpu"))
    ws.permanova(inputs["labels"], PERMUTATIONS, key=KEYS[0])
    assert "square" not in ws.cache and "gram" not in ws.cache


def fault_inverse_design(monkeypatch):
    """PERMANOVA's permuted designs gathered by the inverse orders: a
    valid permutation null, but not that of the documented draw."""
    permanova = importlib.import_module("repro_torch.stats.permanova")
    designs = permanova._permuted_designs

    def inverse(z, orders):
        return designs(z, torch.argsort(orders.long(), dim=1))
    monkeypatch.setattr(permanova, "_permuted_designs", inverse)


def fault_ordinal_ranks(monkeypatch):
    """ANOSIM's ranks taken in sorted order, ties not averaged."""
    anosim = importlib.import_module("repro_torch.stats.anosim")

    def ordinal(v):
        return torch.argsort(torch.argsort(v, stable=True)).to(v.dtype) + 1
    monkeypatch.setattr(anosim, "_rank_average", ordinal)


def fault_dropped_group(monkeypatch):
    """PERMANOVA's last group left out of SS_among, so that SS_within =
    SS_total - SS_among carries its whole quadratic form."""
    permanova = importlib.import_module("repro_torch.stats.permanova")

    def dropped(inv, s, n, num_groups):
        inv = {**inv, "sizes": inv["sizes"][:-1]}
        return pseudo_f(inv, s[..., :-1], n, num_groups)
    pseudo_f = permanova._pseudo_f
    monkeypatch.setattr(permanova, "_pseudo_f", dropped)


FAULTS = [
    (fault_inverse_design, "permanova",
     lambda: study_square(effect=0.0), {"matrix": "x"}, "permanova_p_outside"),
    (fault_ordinal_ranks, "anosim", lambda: study_square(ties=True),
     {"matrix": "x"}, "anosim_gap"),
    (fault_dropped_group, "permanova", study_square, {"matrix": "x"},
     "permanova_gap"),
    (fault_dropped_group, "permanova", study_table, {"table": "table"},
     "permanova_gap"),
]


@pytest.mark.parametrize("plant,test,data,args,reading", FAULTS,
                         ids=["inverse_design", "ordinal_ranks",
                              "dropped_group-square",
                              "dropped_group-operator"])
def test_a_planted_fault_reads_not_correct(plant, test, data, args, reading,
                                           monkeypatch):
    inputs = data()
    workload = SITES if "table" in args else BATTERY
    assert harness.passed(judge(test, inputs, args, workload)[reading])
    plant(monkeypatch)
    assert not harness.passed(judge(test, inputs, args, workload)[reading])


def test_the_sites_maker_keeps_the_table_and_gives_its_sites(monkeypatch):
    config = {"n": 50, "d": 300, "sites": 6, "depth": 500,
              "pool_share": 0.02, "spread_otu": 2.5, "spread_site": 1.0,
              "spread_sample": 1.0}
    plan = traffic.Plan({"calls": []}, 2**31 + 99)
    cpu = torch.device("cpu")
    drawn, randperm = [], torch.randperm

    def recorded(*args, **kwargs):
        drawn.append(randperm(*args, **kwargs))
        return drawn[-1]
    monkeypatch.setattr(torch, "randperm", recorded)
    out = module("inputs", "rarefied_counts_sites").make(config, plan, cpu)
    monkeypatch.undo()
    table = module("inputs", "rarefied_counts").make(config, plan,
                                                     cpu)["table"]
    assert torch.equal(out["table"], table)
    sites = out["sites"]
    assert isinstance(sites, np.ndarray) and sites.dtype == np.int64
    # the first draw is the table maker's own, the sites its codes
    assert np.array_equal(sites, (drawn[0] % 6).numpy())
    sizes = np.bincount(sites, minlength=6)
    assert sizes.max() - sizes.min() <= 1 and sizes.sum() == 50


@pytest.mark.parametrize("n,permutations", [(4, 3), (4743, 999)])
def test_permanova_work_is_the_same_in_both_forms(n, permutations):
    work = module("work", "permanova")
    square_form = work.count({"x": torch.zeros(n, 1).expand(n, n)},
                             {"matrix": "x", "permutations": permutations})
    operator_form = work.count({"table": torch.zeros(n, 3)},
                               {"table": "table",
                                "permutations": permutations})
    assert square_form == operator_form
    m = n * (n - 1) // 2
    assert square_form == {"ops": 2 * permutations * m, "bytes": 4 * m,
                           "precision": "fp32"}


def test_the_other_work_counts_by_hand():
    d = torch.zeros(20, 20)
    assert module("work", "anosim").count(
        {"x": torch.zeros(4, 4)}, {"matrix": "x", "permutations": 3}) == {
        "ops": 42, "bytes": 24, "precision": "fp32"}
    # the ordination of work/pcoa.py (64800) and 2 n k a permutation
    assert module("work", "permdisp").count(
        {"x": d}, {"matrix": "x", "dimensions": 10,
                   "permutations": 5}) == {
        "ops": 64800 + 2 * 20 * 10 * 5, "bytes": 1600, "precision": "fp32"}
    assert module("work", "square_session").count(
        {"x": torch.zeros(3, 3)}, {"matrix": "x"}) == {
        "ops": 6, "bytes": 36, "precision": "fp32"}


def test_the_battery_groups_are_contiguous_and_near_equal():
    from perfbench.reference.groups import grouping
    codes = grouping({}, {"groups": 4}, 16384)
    assert codes.dtype == np.int64
    assert np.array_equal(np.bincount(codes), [4096] * 4)
    assert np.all(np.diff(codes) >= 0)
    assert np.array_equal(np.bincount(grouping({}, {"groups": 4}, 10)),
                          [3, 2, 3, 2])


@pytest.mark.parametrize("workload", [BATTERY, SITES])
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_of_each_grouping_cell(workload, trace):
    result = harness.run_cell(ROOT, workload, 2**31 + 5, 0.2, trace, "cpu",
                              TINY[workload])
    assert result["correct"] and result["failed"] == 0, result["checks"]
    names = set(result["metrics"])
    if trace:
        assert "permanova_s.study" in names
        assert ("hoist_s.study" in names) == (workload == BATTERY)
    else:
        assert names == {"setup_s", "study_s"}
    json.dumps(harness.finite(result))


def test_only_the_last_study_keeps_more_than_its_answers():
    cell = manifest.resolve(manifest.load_json(ROOT / "BENCHMARK.json"),
                            SITES)
    bench = harness.Bench(cell, 8, torch.device("cpu"), TINY[SITES])
    studies, failed, _ = bench.window(0.0, count=3)
    kept = [s.outputs["permanova"] for s in studies]
    assert not failed
    assert [set(k) for k in kept[:2]] == [{"statistic", "p_value"}] * 2
    assert kept[2]["square"] is False and kept[2]["launches"] is None


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_a_null_studys_statistics_keep_to_the_batterys_limits(seed):
    """At n = 2048, 4 contiguous groups of points drawn apart from them
    (the battery's study, smaller): F near 1, so SS_among is about 3 / n
    of SS_total and the fp32 rounding of G's centring means, or of the
    dispersions' group means taken before their grand mean, moved F by
    up to 4e-5 and 1e-4 of itself; both stay within the cell's limits."""
    from repro_torch.api.config import ExecConfig
    from repro_torch.api.workspace import Workspace
    n = 2048
    inputs = {"x": module("inputs", "square_pair").distances(
        torch.randn((n, 8), generator=torch.Generator().manual_seed(seed)))}
    args = {"matrix": "x", "groups": 4, "dimensions": 10}
    from perfbench.reference import groups
    codes, num = groups.labels(inputs, args, "cpu")
    ws = Workspace(inputs["x"], config=ExecConfig(device="cpu"))
    got = {"permanova": ws.permanova(codes.numpy(), 0).statistic,
           "permdisp": ws.permdisp(codes.numpy(), 0,
                                   dimensions=10).statistic}
    bound = limits(BATTERY)
    for test, cls in (("permanova", "Permanova"), ("permdisp", "Permdisp")):
        ref = getattr(module("reference", test), cls)(
            inputs["x"], codes, num, "fp64", args).observed()
        assert abs(got[test] - ref) / max(ref, 1.0) <= bound[f"{test}_gap"], \
            test


class FixedF:
    """A reference whose statistic is ``args["f"]``."""

    def __init__(self, d, codes, groups, precision, args):
        self.f = args["f"]

    def observed(self):
        return self.f


@pytest.mark.parametrize("f,gap", [(0.1, 1e-6), (1.0, 1e-6), (5.0, 2e-7)])
def test_an_f_gap_is_a_share_of_f_or_of_one(f, gap):
    """A null study's F lies near 1 and often far below it: its gap is a
    share of 1 there, so that the share does not grow as 1 / F."""
    from perfbench.reference import groups
    args = {"matrix": "x", "groups": 2, "permutations": 9,
            "checked_studies": 0, "f": f}
    studies = [harness.Study(KEYS[0], {"t": {"statistic": f + 1e-6,
                                            "p_value": 0.5}})]
    readings = groups.judge_test(FixedF, "t", {"x": torch.zeros(4, 4)}, args,
                                 studies, np.random.default_rng(0),
                                 {"t_gap": 1.0}, False, "t", relative=True)
    assert readings == {"t_gap": pytest.approx(gap), "t_p_outside": 0}
