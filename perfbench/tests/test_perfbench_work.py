"""Work counts, least times, the traffic plan and the metric readers,
against values worked out by hand at small sizes."""

from pathlib import Path

import pytest
import torch

from perfbench import harness, manifest, roofline, traffic
from perfbench import trace as tracing

BENCH = Path(__file__).resolve().parents[1]


def work(entry):
    return manifest.load_module(BENCH / "work" / f"{entry}.py")


def reader(metric):
    return manifest.load_module(BENCH / "metrics" / f"{metric}.py")


def test_mantel_counts_k_products_and_sums_and_two_squares():
    x = torch.zeros(4, 4)
    count = work("mantel").count({"x": x, "y": x},
                                 {"x": "x", "y": "y", "permutations": 3})
    # m = 6 pairs, 3 permutations, a product and a sum each; 2 x 16 floats
    assert count == {"ops": 36, "bytes": 128, "precision": "fp32"}


def test_pcoa_counts_the_row_means_and_four_products():
    d = torch.zeros(20, 20)
    count = work("pcoa").count({"x": d}, {"matrix": "x", "dimensions": 10})
    # p = min(10 + 10, 20) = 20: 2*400 + 4 * 2*400*20
    assert count == {"ops": 64800, "bytes": 1600, "precision": "fp32"}


def test_workspace_pcoa_reads_the_condensed_vector_once():
    t = torch.zeros(20, 3)
    count = work("workspace_pcoa").count({"table": t},
                                         {"table": "table", "dimensions": 10})
    assert count == {"ops": 64000, "bytes": 760, "precision": "fp32"}


def test_validate_counts_each_pair_and_the_diagonal():
    d = torch.zeros(3, 3)
    count = work("validate").count({"x": d, "y": d}, {"matrices": ["x", "y"]})
    assert count == {"ops": 12, "bytes": 72, "precision": "fp32"}


def test_production_counts_the_features_both_samples_hold():
    table = torch.tensor([[1.0, 0.0], [2.0, 3.0], [0.0, 4.0]])
    count = work("production").count({"table": table}, {"table": "table"})
    # each feature held by 2 samples: 1 shared pair each -> 2 x (min, add);
    # 4 a pair to finish over 3 pairs; 6 adds of the row sums
    assert count == {"ops": 22.0, "bytes": 36, "precision": "fp32"}


def test_least_says_which_bound_applies():
    peak = roofline.peak_for("NVIDIA H100 80GB HBM3")
    assert peak["bytes_per_s"] == 3.35e12
    by_ops = roofline.least({"ops": 6.7e13, "bytes": 1.0,
                             "precision": "fp32"}, peak)
    assert by_ops == {"seconds": 1.0, "bound": "operations"}
    by_bytes = roofline.least({"ops": 1.0, "bytes": 6.7e12,
                               "precision": "fp32"}, peak)
    assert by_bytes == {"seconds": 2.0, "bound": "bytes"}
    assert roofline.peak_for("cpu") is None
    assert roofline.least({"ops": 1, "bytes": 1, "precision": "fp32"},
                          None) is None


def test_plan_draws_the_same_keys_from_the_same_seed():
    mix = {"calls": []}
    seed = 2**31 + 12345
    a, b, c = (traffic.Plan(mix, s) for s in (seed, seed, seed + 1))
    assert [a.key(i) for i in range(5)] == [b.key(i) for i in range(5)]
    assert a.key(0) != c.key(0) and a.key(0) != a.key(1)
    assert a.warmup_key not in {a.key(i) for i in range(100)}
    assert all(0 <= a.key(i) < 2**63 for i in range(100))
    assert a.input_seed("x") != a.input_seed("y")
    assert a.rng("mantel").integers(1 << 30) == b.rng("mantel").integers(
        1 << 30)
    assert a.rng("mantel").integers(1 << 30) != a.rng("pcoa").integers(
        1 << 30)


def make_run(trace=None, least=None):
    return harness.Run(setup_s=12.5, window_s=10.0, studies=4,
                       peak_bytes=6_000_000_000,
                       least=least or {"mantel": {"seconds": 0.004},
                                       "pcoa": {"seconds": 0.001}},
                       trace=trace)


def test_end_to_end_readers():
    run = make_run()
    assert reader("setup_s").read(run) == 12.5
    assert reader("study_s").read(run) == 2.5
    assert reader("peak_mem_gb").read(run) == 6.0
    # a study's least 0.005 s over the untraced window's 2.5 s a study
    assert reader("mfu.study").read(run) == pytest.approx(100 * 0.005 / 2.5)
    for metric in ("mantel_s.study", "pcoa_s.study", "production_s.study",
                   "mantel_roofline", "idle.study"):
        assert reader(metric).read(run) is None


def test_device_readers_from_a_trace():
    # traced window 0..10 s; mantel spans [0, 2] and [5, 7], pcoa [2, 3];
    # kernels [0.5, 1.5] and [1.8, 2.2] launched at 0.1 and 1.7 (mantel)
    # and [6, 7.5] launched at 5.5 (mantel, ending after its span), one
    # [2.5, 2.9] launched at 2.4 (pcoa)
    us = 1e6
    events = [{"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW,
               "ts": 0, "dur": 10 * us}]
    for name, lo, hi in (("mantel", 0, 2), ("pcoa", 2, 3), ("mantel", 5, 7)):
        events.append({"ph": "X", "cat": "user_annotation",
                       "name": tracing.SPAN_PREFIX + name,
                       "ts": lo * us, "dur": (hi - lo) * us})
    for corr, (at, lo, hi) in enumerate(((0.1, 0.5, 1.5), (1.7, 1.8, 2.2),
                                         (5.5, 6.0, 7.5), (2.4, 2.5, 2.9))):
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": at * us, "dur": 1,
                       "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": "k",
                       "ts": lo * us, "dur": (hi - lo) * us,
                       "args": {"correlation": corr}})
    trace = tracing.reduce(events)
    run = harness.Run(setup_s=1.0, window_s=8.0, studies=4, peak_bytes=None,
                      least={"mantel": {"seconds": 0.01},
                             "pcoa": {"seconds": 0.002}}, trace=trace)
    # mantel busy: 1.0 + 0.4 + 1.5 = 2.9 s for 2 calls of 0.01 s least
    assert reader("mantel_roofline").read(run) == pytest.approx(
        100 * 0.02 / 2.9)
    assert reader("pcoa_roofline").read(run) == pytest.approx(100 * 0.002
                                                              / 0.4)
    # mantel: [0, 2.2] and [5, 7.5], 2.35 s a call; pcoa 1 s
    assert reader("mantel_s.study").read(run) == pytest.approx(2.35)
    assert reader("pcoa_s.study").read(run) == pytest.approx(1.0)
    assert reader("production_s.study").read(run) is None
    assert reader("idle.study").read(run) == pytest.approx(100 * (1 - 3.3
                                                                  / 10))
    # least of a study 0.012 s over the untraced 2 s a study
    assert reader("mfu.study").read(run) == pytest.approx(100 * 0.012 / 2)
    assert reader("peak_mem_gb").read(run) is None


def test_device_readers_stay_silent_without_a_device():
    run = make_run(least={"mantel": None, "pcoa": None})
    for metric in ("mantel_roofline", "pcoa_roofline", "idle.study",
                   "mfu.study"):
        assert reader(metric).read(run) is None


def test_mantel_least_time_at_the_cell_size():
    count = work("mantel").count(
        {"x": torch.zeros(16384, 1)}, {"x": "x", "permutations": 999})
    least = roofline.least(count, roofline.peak_for("H100"))
    m = 16384 * 16383 // 2
    assert least["bound"] == "operations"
    assert least["seconds"] == pytest.approx(2 * 999 * m / 6.7e13)
    assert least["seconds"] == pytest.approx(0.004, rel=0.01)


def test_tf32_rounding_keeps_ten_mantissa_bits_ties_to_even():
    from perfbench.reference.precision import round_tf32
    x = torch.tensor([1 + 2**-11, 1 + 3 * 2**-11, 1 + 2**-10,
                      -1 - 3 * 2**-11, 1 + 2**-11 + 2**-20])
    assert round_tf32(x).tolist() == [1.0, 1 + 2**-9, 1 + 2**-10,
                                      -1 - 2**-9, 1 + 2**-10]


def test_reference_braycurtis_matches_the_direct_sum():
    """Comparing over a row's nonzeros gives sum|a - b| / sum(a + b) for
    any signs, and 0 where both rows are all zeros."""
    from perfbench.reference.production import braycurtis
    gen = torch.Generator().manual_seed(3)
    t = torch.randn((37, 50), generator=gen, dtype=torch.float64)
    t[torch.rand((37, 50), generator=gen) < 0.8] = 0.0
    t[5] = 0.0
    t[6] = 0.0
    t[:20] = t[:20].abs()
    got = braycurtis(t)
    i, j = torch.triu_indices(37, 37, offset=1)
    num = (t[i] - t[j]).abs().sum(dim=1)
    den = (t[i] + t[j]).sum(dim=1)
    want = torch.where(den != 0, num / torch.where(den != 0, den, 1), 0)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    pair = {(int(a), int(b)): k for k, (a, b) in enumerate(zip(i, j))}
    assert float(got[pair[5, 6]]) == 0.0
    assert float(t[7].sum()) > 0 and float(got[pair[5, 7]]) == 1.0


def test_rarefied_counts_keep_depth_sites_and_seed():
    inputs = manifest.load_module(BENCH / "inputs" / "rarefied_counts.py")
    config = {"n": 40, "d": 300, "sites": 4, "depth": 500,
              "pool_share": 0.02, "spread_otu": 2.5, "spread_site": 1.0,
              "spread_sample": 1.0}
    plan = traffic.Plan({"calls": []}, 2**31 + 99)
    a = inputs.make(config, plan, torch.device("cpu"))["table"]
    b = inputs.make(config, plan, torch.device("cpu"))["table"]
    c = inputs.make(config, traffic.Plan({"calls": []}, 5),
                    torch.device("cpu"))["table"]
    assert a.shape == (40, 300) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.all(a.sum(dim=1) == 500)
    assert torch.equal(a, a.round()) and float(a.min()) == 0.0
    assert 0.0 < float((a > 0).float().mean()) < 0.5
