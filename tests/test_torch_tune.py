"""``repro_torch.tune`` against ``repro.tune``: the cases of
``tests/test_tune.py`` through the port, the port's model and solver held
against the reference's under the same ``BackendBudget`` (tiles equal,
modeled floats equal), and the card's budget from a stated property set.

Under a reference budget the solver must return the reference's tiles and
floats exactly: the arithmetic is the same closed forms in float64, so no
tolerance is needed. The card's solve is held to its properties: S·B <= 128
outputs a launch, the 128 cap, ``block`` and ``feature_block`` shrink-only,
never a worse modeled traffic than the defaults, and K nowhere among its
inputs. ``ExecConfig(auto=True)`` sessions are held bitwise against the
default-config run of the port on the same seeds (the reference's own
acceptance battery), and their observed statistics against the
reference's to 1e-5.
"""

import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.tune import BackendBudget as JaxBudget
from repro.tune import solve_tiles as jax_solve_tiles
from repro.tune import model as jax_model
from repro_torch.api import ExecConfig, Workspace
from repro_torch.core import random_distance_matrix
from repro_torch.core.distance_matrix import MAX_TRIANGLE_N
from repro_torch.core.mantel import MantelStatistic
from repro_torch.kernels.permute_reduce import MAX_OUTPUTS
from repro_torch.obs import sentinel
from repro_torch.obs.ledger import (HOIST_PASSES, ROW_STATIONARY_OUTPUTS,
                                    perm_traffic_floats, production_floats,
                                    row_stationary_floats)
from repro_torch.stats.engine import permutation_test
from repro_torch.tune import (BackendBudget, calibrate, detect_budget,
                              load_profile, perm_batch_cost, production_cost,
                              save_profile, solve_tiles)
from repro_torch.tune.model import (SQUARE_SESSION_ARTIFACTS,
                                    STANDALONE_SESSION_ARTIFACTS,
                                    matvec_card_cost, perm_card_cost,
                                    production_card_cost,
                                    session_hoist_passes)
from repro_torch.tune.solve import (BATCH_MAX, CARD_UNREAD, DEFAULT_BATCH,
                                    DEFAULT_BLOCK, DEFAULT_CHUNK,
                                    DEFAULT_FEATURE_BLOCK)

CPU = ExecConfig(device="cpu")
AUTO = ExecConfig(device="cpu", auto=True)
#: an H100's budget as ``detect_budget()`` reads it on the card: 50 MB of
#: L2, 227 KB of opt-in shared memory a block, 80 GB of HBM
H100 = BackendBudget(backend="cuda", working_bytes=50 * 2**20,
                     capacity_bytes=80 * 2**30, bandwidth=3.35e12,
                     latency=5e-6, shared_bytes=227 * 1024,
                     device="NVIDIA H100 80GB HBM3")


def _budget(working_bytes, backend="cpu"):
    return BackendBudget(backend=backend, working_bytes=working_bytes,
                         capacity_bytes=32 * 2**20, bandwidth=3e10,
                         latency=30e-6)


def _card(shared_bytes=227 * 1024, working_bytes=50 * 2**20):
    return dataclasses.replace(H100, shared_bytes=shared_bytes,
                               working_bytes=working_bytes)


def _as_ref(budget):
    d = budget.to_dict()
    return JaxBudget(**{k: d[k] for k in ("backend", "working_bytes",
                                          "capacity_bytes", "bandwidth",
                                          "latency", "source")})


def _features(seed, n=48, d=12):
    rng = np.random.default_rng(seed)
    return rng.random((n, d), dtype=np.float32) + 0.01


def _dm(seed, n):
    return random_distance_matrix(seed, n, device="cpu")


# --------------------------------------------------------------------------
# the port's solver IS the reference's under a reference budget
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n", [64, 700, 2048])
@pytest.mark.parametrize("d", [None, 8, 256])
@pytest.mark.parametrize("working_bytes", [64 * 1024, 2**20, 16 * 2**20])
def test_solver_matches_reference(n, d, working_bytes):
    budget = _budget(working_bytes)
    got = solve_tiles(n, d, budget=budget)
    want = jax_solve_tiles(n, d, budget=_as_ref(budget))
    for knob in ("block", "feature_block", "batch_size", "chunk"):
        assert getattr(got, knob) == getattr(want, knob), knob
    assert got.modeled == want.modeled
    assert got.modeled_default == want.modeled_default
    assert got.unread == ()


def test_solver_reproduces_bench_tune():
    """``BENCH_tune.json`` at n = 2048, d = 256 under the CPU column."""
    with open("BENCH_tune.json") as f:
        bench = json.load(f)
    budget = BackendBudget.from_dict(bench["budget"])
    for backing, d in (("dm", None), ("features", bench["d"])):
        t = solve_tiles(2048, d, budget=budget)
        want = bench["results"]["2048"]["tiles"][backing]
        assert {k: getattr(t, k) for k in want} == want, backing
    dm = solve_tiles(2048, budget=budget).to_dict()
    mantel = bench["results"]["2048"]["suites"]["mantel"]["perm_batch"]
    assert dm["modeled"]["perm_batch"]["traffic_floats"] == \
        mantel["tuned_floats"]
    assert dm["modeled_default"]["perm_batch"]["traffic_floats"] == \
        mantel["default_floats"]


def test_cost_terms_match_reference():
    for n, b, c, s in [(2048, 32, 65536, 1), (700, 64, 4096, 2),
                       (64, 8, 2016, 1)]:
        assert perm_batch_cost(n, b, c, s, budget_floats=2**18).to_dict() \
            == jax_model.perm_batch_cost(n, b, c, s,
                                         budget_floats=2**18).to_dict()
    for n, d, b, fb in [(100, 10, 32, 8), (2048, 128, 256, 128)]:
        assert production_cost(n, d, b, fb).to_dict() == \
            jax_model.production_cost(n, d, b, fb).to_dict()
    assert session_hoist_passes(STANDALONE_SESSION_ARTIFACTS) == \
        jax_model.session_hoist_passes(
            jax_model.STANDALONE_SESSION_ARTIFACTS)


# --------------------------------------------------------------------------
# ledger/model parity — the two can never drift (tests/test_tune.py)
# --------------------------------------------------------------------------
def test_model_reproduces_published_mantel_ratio():
    cost = perm_batch_cost(2048, 32, 65536, s=1)
    ledger = perm_traffic_floats(2048, 32)
    assert cost.traffic_floats == ledger["condensed_fused"]
    assert ledger["square_gather"] / cost.traffic_floats == \
        pytest.approx(10.97, abs=0.005)


def test_model_reproduces_published_api_session_passes():
    assert session_hoist_passes(SQUARE_SESSION_ARTIFACTS) == 11.0
    assert session_hoist_passes(STANDALONE_SESSION_ARTIFACTS) == 16.0
    assert session_hoist_passes(SQUARE_SESSION_ARTIFACTS,
                                feature_backed=True) < 11.0


def test_model_production_parity_with_ledger():
    for n, d, b in [(100, 10, 32), (2048, 128, 256), (64, 8, 512)]:
        assert production_cost(n, d, b).traffic_floats == \
            production_floats(n, d, b)


def test_model_traffic_monotone_in_n_and_k():
    per_perm = [perm_batch_cost(n, 32, 65536).traffic_floats
                for n in (64, 128, 512, 2048, 4096)]
    assert all(a <= b for a, b in zip(per_perm, per_perm[1:]))
    prod = [production_cost(n, 64, 256).traffic_floats
            for n in (64, 128, 512, 2048)]
    assert all(a <= b for a, b in zip(prod, prod[1:]))
    card = [perm_card_cost(n, 32, 1).traffic_floats
            for n in (64, 128, 512, 2048, 16384)]
    assert all(a <= b for a, b in zip(card, card[1:]))
    for k1, k2 in [(99, 999), (999, 9999)]:
        assert per_perm[0] * k1 <= per_perm[0] * k2


def test_row_stationary_model_is_the_kernels_geometry():
    """The ledger's row-stationary entry: 4m(S·B + L) + 8nB bytes a tile,
    L launches of P = min(B, 128/S); its per-launch cap is the kernel's."""
    assert ROW_STATIONARY_OUTPUTS == MAX_OUTPUTS
    n, m = 16384, 16384 * 16383 // 2
    for b, s, launches in [(32, 1, 1), (64, 2, 1), (128, 2, 2), (128, 1, 1)]:
        tile_bytes = 4 * m * (s * b + launches) + 8 * n * b
        assert row_stationary_floats(n, b, s) * 4 * b == \
            pytest.approx(tile_bytes, rel=1e-12)
        cost = perm_card_cost(n, b, s)
        assert cost.params["launches_per_tile"] == launches
        assert cost.resident_bytes == max(4 * n, 16 * 8 * s
                                          * min(b, MAX_OUTPUTS // s))
    assert matvec_card_cost(n, 130).params["launches"] == 2


#: the card's costs as the tuner priced them while it kept its own copies
#: of the kernels' geometry: (traffic_floats, resident_floats, base_floats)
#: and the parameters; the launch modules' statement must price the same
PINNED_CARD_COSTS = [
    (perm_card_cost, (2, 32, 1), (5.03125, 1024.0, 1.0),
     {"perms_per_launch": 32, "launches_per_tile": 1}),
    (perm_card_cost, (700, 32, 1), (253695.3125, 1024.0, 244650.0),
     {"perms_per_launch": 32, "launches_per_tile": 1}),
    (perm_card_cost, (16384, 32, 1), (138436352.0, 16384.0, 134209536.0),
     {"perms_per_launch": 32, "launches_per_tile": 1}),
    (perm_card_cost, (16384, 128, 2), (270548864.0, 16384.0, 134209536.0),
     {"perms_per_launch": 64, "launches_per_tile": 2}),
    (perm_card_cost, (4743, 64, 2), (22676505.328125, 4743.0, 11245653.0),
     {"perms_per_launch": 64, "launches_per_tile": 1}),
    (production_card_cost, (700, 64, 256), (179200.0, 195584.0, 0.0),
     {"block": 256}),
    (production_card_cost, (4743, 45383, 256),
     (4305031380.0, 12832256.0, 0.0), {"block": 256}),
    (production_card_cost, (16384, 2048, 128),
     (4328521728.0, 2359296.0, 0.0), {"block": 128}),
    (matvec_card_cost, (700, 16), (490000.0, 27648.0, 0.0),
     {"strip_rows": 128, "launches": 1}),
    (matvec_card_cost, (16384, 20), (268435456.0, 28416.0, 0.0),
     {"strip_rows": 128, "launches": 1}),
    (matvec_card_cost, (16384, 64), (268435456.0, 36864.0, 0.0),
     {"strip_rows": 128, "launches": 1}),
]

#: ``solve_tiles`` on card budgets (n, d, shared bytes, L2 bytes): the
#: tiles (block, feature_block, batch_size, chunk) and each modeled op's
#: (traffic_floats, resident_floats), solved and default
PINNED_CARD_SOLVES = [
    ((16384, None, 227 * 1024, 50 * 2**20), (256, 128, 64, 65536),
     {"matvec": (268435456.0, 27648.0), "perm_batch": (270548864.0, 16384.0)},
     {"matvec": (268435456.0, 27648.0), "perm_batch": (272645888.0, 16384.0)}),
    ((4743, 45383, 227 * 1024, 50 * 2**20), (256, 128, 64, 65536),
     {"matvec": (22496049.0, 27648.0),
      "perm_batch": (22676505.328125, 4743.0),
      "production": (4305031380.0, 12832256.0)},
     {"matvec": (22496049.0, 27648.0), "perm_batch": (22852218.65625, 4743.0),
      "production": (4305031380.0, 12832256.0)}),
    ((2048, 512, 48 * 1024, 2**20), (64, 128, 64, 65536),
     {"matvec": (4194304.0, 27648.0), "perm_batch": (4229104.0, 4096.0),
      "production": (34603008.0, 163840.0)},
     {"matvec": (4194304.0, 27648.0), "perm_batch": (4261856.0, 2048.0),
      "production": (34603008.0, 163840.0)}),
    ((700, 8, 4 * 1024, 4 * 2**20), (256, 8, 16, 65536),
     {"matvec": (490000.0, 27648.0), "perm_batch": (505990.625, 1024.0),
      "production": (22400.0, 181248.0)},
     {"matvec": (490000.0, 27648.0), "perm_batch": (498345.3125, 2048.0),
      "production": (22400.0, 181248.0)}),
]


@pytest.mark.parametrize("cost, args, floats, params", PINNED_CARD_COSTS)
def test_card_costs_are_the_pinned_figures(cost, args, floats, params):
    """The card's cost terms read the kernels' geometry from the launch
    modules and price what the tuner's own copies priced."""
    c = cost(*args)
    assert (c.traffic_floats, c.resident_floats, c.base_floats) == floats
    assert {k: c.params[k] for k in params} == params


def test_matvec_card_cost_reads_the_kernels_ring():
    """Above 64 columns ``center_matvec`` keeps a ring of 4 stages, not 6:
    the resident set reads ``ring_stages`` of the launch module."""
    from repro_torch.kernels.center_matvec import geometry, ring_stages
    assert [ring_stages(k) for k in (1, 64, 65, 128)] == [6, 6, 4, 4]
    c = matvec_card_cost(4743, 130)
    assert c.params["launches"] == geometry(4743, 4743, 130)["launches"] == 2
    assert c.resident_floats == 4 * 32 * (128 + 128)
    assert c.traffic_floats == 2 * 4743 * 4743


@pytest.mark.parametrize("shape, tiles, modeled, default", PINNED_CARD_SOLVES)
def test_card_solve_is_the_pinned_solve(shape, tiles, modeled, default):
    n, d, shared, working = shape
    t = solve_tiles(n, d, budget=_card(shared_bytes=shared,
                                       working_bytes=working))
    assert (t.block, t.feature_block, t.batch_size, t.chunk) == tiles
    for got, want in ((t.modeled, modeled), (t.modeled_default, default)):
        assert {op: (c["traffic_floats"], c["resident_floats"])
                for op, c in got.items()} == want


# --------------------------------------------------------------------------
# solver properties (tests/test_tune.py), on both budgets
# --------------------------------------------------------------------------
def test_solver_choices_fit_stated_budget():
    rng = np.random.default_rng(0)
    for _ in range(25):
        n = int(rng.integers(8, 3000))
        d = int(rng.integers(2, 800))
        budget = _budget(int(rng.integers(256, 16 * 1024)) * 1024)
        t = solve_tiles(n, d, budget=budget)
        bf = budget.working_floats
        assert perm_batch_cost(n, t.batch_size, t.chunk,
                               s=2).resident_floats <= bf
        assert production_cost(n, d, t.block,
                               t.feature_block).resident_floats <= bf
        ref = jax_solve_tiles(n, d, budget=_as_ref(budget))
        assert (t.block, t.feature_block, t.batch_size, t.chunk) == \
            (ref.block, ref.feature_block, ref.batch_size, ref.chunk)


def test_solver_never_models_worse_than_defaults():
    for budget in (_budget(256 * 1024), _budget(2**20),
                   _budget(16 * 2**20), H100,
                   _card(shared_bytes=48 * 1024, working_bytes=4 * 2**20)):
        for n, d in [(48, 8), (512, 64), (2048, 128), (300, None),
                     (16384, 2048)]:
            td = solve_tiles(n, d, budget=budget).to_dict()
            for op in td["modeled"]:
                assert (td["modeled"][op]["traffic_floats"]
                        <= td["modeled_default"][op]["traffic_floats"]), \
                    (op, n, d, budget.backend)


def test_solver_is_k_independent_and_capped():
    params = inspect.signature(solve_tiles).parameters
    assert "K" not in params and "permutations" not in params
    assert solve_tiles(64, budget=_budget(64 * 2**20)).batch_size <= \
        BATCH_MAX
    assert solve_tiles(64, budget=_card(shared_bytes=2**30)).batch_size <= \
        BATCH_MAX


def test_solver_respects_int32_triangle_guard():
    for budget in (_budget(2**20), H100):
        with pytest.raises(ValueError, match="int32 triangle"):
            solve_tiles(MAX_TRIANGLE_N + 1, budget=budget)
        assert solve_tiles(MAX_TRIANGLE_N, budget=budget).batch_size >= 1


def test_solver_feature_block_and_block_shrink_only():
    for budget in (_budget(64 * 1024), _budget(2**20), _budget(16 * 2**20),
                   H100, _card(working_bytes=2**20)):
        for n, d in [(128, 16), (2048, 512), (1000, 4), (16384, 2048)]:
            t = solve_tiles(n, d, budget=budget)
            assert t.feature_block <= min(DEFAULT_FEATURE_BLOCK, d)
            assert t.block <= DEFAULT_BLOCK
    roomy = solve_tiles(2048, 64, budget=_budget(64 * 2**20))
    assert roomy.block == DEFAULT_BLOCK
    assert roomy.feature_block == min(DEFAULT_FEATURE_BLOCK, 64)


def test_solved_defaults_match_constants():
    from repro_torch.dist import driver
    from repro_torch.kernels import permute_reduce_ops
    from repro_torch.stats.engine import WORKSPACE_BATCH
    assert DEFAULT_CHUNK == permute_reduce_ops.DEFAULT_CHUNK
    assert DEFAULT_BLOCK == driver.DEFAULT_BLOCK
    assert DEFAULT_FEATURE_BLOCK == 128
    assert DEFAULT_BATCH == WORKSPACE_BATCH == 32


# --------------------------------------------------------------------------
# the card's budget: stated properties
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 256, 700, 16384, MAX_TRIANGLE_N])
@pytest.mark.parametrize("s", [1, 2])
def test_card_batch_fits_one_launch(n, s):
    """The card's batch: one ``permute_reduce`` launch a tile (S·B <= 128),
    its block within the opt-in shared memory, capped at 128, and the
    largest candidate that does so (traffic falls with B up to there)."""
    t = solve_tiles(n, budget=H100, s=s)
    assert s * t.batch_size <= MAX_OUTPUTS
    assert t.batch_size <= BATCH_MAX
    cost = perm_card_cost(n, t.batch_size, s)
    assert cost.resident_bytes <= H100.shared_bytes
    assert cost.params["launches_per_tile"] == 1
    assert t.batch_size == MAX_OUTPUTS // s
    assert t.unread == CARD_UNREAD == ("chunk", "feature_block")
    assert t.chunk == min(DEFAULT_CHUNK, -(-max(n * (n - 1) // 2, 1) // 8)
                          * 8)


def test_card_batch_shrinks_with_shared_memory():
    """A card whose blocks hold less shared memory than a 16384-row of x
    gets no batch that needs more."""
    small = _card(shared_bytes=48 * 1024)
    t = solve_tiles(2048, budget=small, s=2)
    assert perm_card_cost(2048, t.batch_size, 2).resident_bytes <= 48 * 1024
    assert t.batch_size == 64
    tiny = _card(shared_bytes=4 * 1024)
    assert solve_tiles(1024, budget=tiny, s=2).batch_size == 16
    # a row of x alone past the block's memory: no batch can help, and
    # the solve keeps the one-launch maximum
    assert solve_tiles(16384, budget=tiny, s=2).batch_size == 64


def test_card_block_shrinks_only_under_l2_pressure():
    assert solve_tiles(16384, 2048, budget=H100).block == DEFAULT_BLOCK
    tight = solve_tiles(16384, 2048, budget=_card(working_bytes=2**20))
    assert tight.block < DEFAULT_BLOCK
    assert (tight.block * 2048 + tight.block * 16384) * 4 <= 2**20


def test_detect_budget_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        detect_budget()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_tiles(64)
    assert detect_budget("cpu") == detect_budget(torch.device("cpu"))


# --------------------------------------------------------------------------
# budget: defaults, calibration, profile round-trip (tests/test_tune.py)
# --------------------------------------------------------------------------
def test_detect_budget_backends():
    from repro.tune import detect_budget as jax_detect
    for be in ("cpu", "tpu", "gpu"):
        b = detect_budget(be)
        assert b.backend == be and b.working_bytes > 0
        assert b.working_bytes <= b.capacity_bytes
        want = jax_detect(be).to_dict()
        assert {k: v for k, v in b.to_dict().items() if k in want} == want
    assert detect_budget("cpu").shared_bytes is None


def test_calibration_profile_roundtrip(tmp_path):
    base = detect_budget("cpu")
    cal = calibrate(base, small=1 << 10, large=1 << 16, reps=2)
    assert cal.source == "calibrated"
    assert cal.bandwidth > 0 and cal.latency >= 0
    assert cal.working_bytes == base.working_bytes
    path = str(tmp_path / "profile.json")
    save_profile(cal, path)
    loaded = load_profile(path)
    assert loaded.source == "profile"
    assert loaded.bandwidth == cal.bandwidth
    assert loaded.working_bytes == cal.working_bytes
    t = solve_tiles(64, profile=path)
    assert t.budget.source == "profile"
    probed = calibrate(base, mode="probe", large=1 << 16)
    assert probed.source == "probed" and probed.latency == base.latency
    assert probed.bandwidth == base.bandwidth      # 8 bytes an element
    with pytest.raises(ValueError, match="mode"):
        calibrate(base, mode="guess")


def test_reference_profile_loads(tmp_path):
    """A profile the reference saved loads, and solves the same tiles."""
    from repro.tune import save_profile as jax_save
    path = str(tmp_path / "ref.json")
    jax_save(JaxBudget("cpu", 2**19, 32 * 2**20, 3e10, 30e-6), path)
    got = solve_tiles(700, 16, profile=path)
    want = jax_solve_tiles(700, 16, profile=path)
    assert (got.block, got.batch_size, got.chunk) == \
        (want.block, want.batch_size, want.chunk)


# --------------------------------------------------------------------------
# ExecConfig auto plumbing (tests/test_tune.py)
# --------------------------------------------------------------------------
def test_execconfig_accepts_and_validates_auto():
    ExecConfig(block="auto", feature_block="auto", batch_size="auto",
               chunk="auto")
    assert ExecConfig(auto=True).needs_resolution
    assert ExecConfig(chunk="auto").needs_resolution
    assert not ExecConfig().needs_resolution
    for bad in ({"block": 0}, {"block": "big"}, {"chunk": -3},
                {"batch_size": "autotune"}, {"feature_block": 0}):
        with pytest.raises(ValueError):
            ExecConfig(**bad)
    hash(ExecConfig(auto=True))
    hash(ExecConfig(block="auto"))
    # the reference's rule: "distributed" needs a mesh; a mesh resolves
    with pytest.raises(ValueError, match="requires a mesh"):
        ExecConfig(centering_impl="distributed")
    mesh = object()
    cfg, _ = ExecConfig(mesh=mesh, auto=True, device="cpu").resolve(256, 32)
    assert cfg.mesh is mesh and not cfg.needs_resolution


def test_execconfig_resolve_materializes_all_knobs():
    cfg, tuned = AUTO.resolve(256, 32)
    assert not cfg.needs_resolution and not cfg.auto
    for knob in ("block", "feature_block", "batch_size", "chunk"):
        assert isinstance(getattr(cfg, knob), int), knob
    assert tuned is not None and tuned.n == 256
    assert tuned.budget == detect_budget("cpu")
    want = jax_solve_tiles(256, 32)              # the reference's CPU column
    assert (cfg.block, cfg.feature_block, cfg.batch_size, cfg.chunk) == \
        (want.block, want.feature_block, want.batch_size, want.chunk)
    assert CPU.resolve(256, 32) == (CPU, None)


def test_execconfig_resolve_honors_explicit_knobs():
    cfg, tuned = ExecConfig(device="cpu", auto=True, block=64,
                            chunk=2048).resolve(512, 16)
    assert cfg.block == 64 and cfg.chunk == 2048
    assert isinstance(cfg.batch_size, int)
    assert tuned is not None


def test_execconfig_resolve_reads_a_card_profile(tmp_path):
    """A saved card budget solves the card's geometry on any host."""
    path = str(tmp_path / "h100.json")
    save_profile(H100, path)
    cfg, tuned = ExecConfig(device="cpu", auto=True,
                            tune_profile=path).resolve(16384, 2048)
    assert tuned.budget.backend == "cuda"
    assert cfg.batch_size == 64 and cfg.block == DEFAULT_BLOCK


# --------------------------------------------------------------------------
# the acceptance battery: auto end-to-end, bitwise vs default
# --------------------------------------------------------------------------
def _feature_sessions(config):
    return tuple(Workspace.from_features(_features(s), config=config)
                 for s in (3, 4, 5))


def test_auto_battery_bitwise_identical_to_default():
    ws_d, wy_d, wz_d = _feature_sessions(CPU)
    ws_a, wy_a, wz_a = _feature_sessions(AUTO)
    assert ws_a.tuned is not None and ws_d.tuned is None
    g = np.arange(48) % 4
    assert torch.equal(ws_a.pcoa(dimensions=6).coordinates,
                       ws_d.pcoa(dimensions=6).coordinates)
    pairs = [
        (ws_a.permanova(g, permutations=99, key=7),
         ws_d.permanova(g, permutations=99, key=7)),
        (ws_a.anosim(g, permutations=99, key=7),
         ws_d.anosim(g, permutations=99, key=7)),
        (ws_a.permdisp(g, permutations=99, key=7, dimensions=6),
         ws_d.permdisp(g, permutations=99, key=7, dimensions=6)),
        (ws_a.mantel(wy_a, permutations=99, key=7),
         ws_d.mantel(wy_d, permutations=99, key=7)),
        (ws_a.partial_mantel(wy_a, wz_a, permutations=99, key=7),
         ws_d.partial_mantel(wy_d, wz_d, permutations=99, key=7)),
    ]
    for ra, rd in pairs:
        assert ra.statistic == rd.statistic
        assert ra.p_value == rd.p_value


def test_auto_statistics_match_reference():
    """The observed statistics of an auto session do not depend on the
    seed: held against the reference's auto session to 1e-5."""
    import jax
    from repro.api import ExecConfig as JaxExecConfig
    from repro.api import Workspace as JaxWorkspace
    ws = Workspace.from_features(_features(3), config=AUTO)
    wy = Workspace.from_features(_features(4), config=AUTO)
    ref = JaxWorkspace.from_features(_features(3),
                                     config=JaxExecConfig(auto=True))
    refy = JaxWorkspace.from_features(_features(4),
                                      config=JaxExecConfig(auto=True))
    g = np.arange(48) % 4
    key = jax.random.PRNGKey(7)
    for got, want in (
            (ws.permanova(g, 19, key=1), ref.permanova(g, 19, key=key)),
            (ws.anosim(g, 19, key=1), ref.anosim(g, 19, key=key)),
            (ws.mantel(wy, 19, key=1), ref.mantel(refy, 19, key=key))):
        assert got.statistic == pytest.approx(float(want.statistic),
                                              abs=1e-5)
    assert {k: getattr(ws.config, k) for k in ("block", "batch_size")} == \
        {k: getattr(ref.config, k) for k in ("block", "batch_size")}


def test_auto_one_program_serves_every_k():
    dm, dm2 = _dm(5, 40), _dm(6, 40)
    ws = Workspace(dm, config=AUTO)
    with sentinel.expect("kernels.permute_reduce", max_programs=1):
        with sentinel.expect("stats.engine.per_batch", max_programs=1):
            ws.mantel(dm2, permutations=49, key=7)
            ws.mantel(dm2, permutations=17, key=7)
            ws.mantel(dm2, permutations=128, key=7)


def test_engine_batch_size_auto_resolves():
    x, y = _dm(0, 36), _dm(1, 36)
    stat = MantelStatistic(x.data, y.data, 36)
    r_auto = permutation_test(stat, permutations=45, key=7,
                              config=ExecConfig(batch_size="auto"),
                              device="cpu")
    r_def = permutation_test(stat, permutations=45, key=7, device="cpu")
    assert r_auto.statistic == r_def.statistic
    assert r_auto.p_value == r_def.p_value


# --------------------------------------------------------------------------
# knob invariance (tests/test_tune.py)
# --------------------------------------------------------------------------
def test_results_invariant_to_block():
    feats = _features(3)
    base = None
    for blk in (16, 48, 256, 1024):
        cond = Workspace.from_features(
            feats, config=ExecConfig(device="cpu", block=blk)).condensed()
        if base is None:
            base = cond
        else:
            assert torch.equal(cond, base), blk
    dm = _dm(2, 48)
    base_c = None
    for blk in (16, 48, 256):
        c = Workspace(dm, config=ExecConfig(device="cpu", block=blk)).pcoa(
            dimensions=5).coordinates
        if base_c is None:
            base_c = c
        else:
            assert torch.allclose(c, base_c, atol=1e-4), blk


def test_pvalues_invariant_to_chunk():
    """``chunk`` is read by no route of the port (the plain
    ``permute_reduce`` keeps its own tile), so the answers are bitwise the
    same whatever it says; the plain version's own chunking moves a null
    sum by an ulp at most."""
    from repro_torch.kernels.permute_reduce_ops import permute_reduce
    from repro_torch.stats.engine import permutation_orders
    x, y = _dm(0, 36), _dm(1, 36)
    rs = [permutation_test(MantelStatistic(x.data, y.data, 36),
                           permutations=45, key=7, batch_size=8,
                           config=ExecConfig(chunk=c), device="cpu")
          for c in (None, 64, 256, 630)]
    for r in rs[1:]:
        assert (r.statistic, r.p_value) == (rs[0].statistic, rs[0].p_value)
    xc = x.condensed_form()
    ys = y.condensed_form()[None]
    orders = permutation_orders(3, 8, 36)
    base = permute_reduce(xc, ys, orders)
    for c in (64, 256, 630):
        torch.testing.assert_close(permute_reduce(xc, ys, orders, chunk=c),
                                   base, rtol=1e-6, atol=1e-6)


def test_feature_block_shrunk_results_close():
    feats = np.random.default_rng(9).random((40, 24), dtype=np.float32) \
        + 0.01
    g = np.arange(40) % 4
    r1 = Workspace.from_features(
        feats, config=ExecConfig(device="cpu", feature_block=24)).permanova(
            g, permutations=49, key=7)
    r2 = Workspace.from_features(
        feats, config=ExecConfig(device="cpu", feature_block=8)).permanova(
            g, permutations=49, key=7)
    assert r1.statistic == pytest.approx(r2.statistic, rel=1e-5)
    assert r1.p_value == r2.p_value


# --------------------------------------------------------------------------
# reporting (tests/test_tune.py)
# --------------------------------------------------------------------------
def test_report_surfaces_resolved_tiles():
    dm = _dm(4, 30)
    ws = Workspace(dm, config=AUTO)
    doc = ws.report().to_dict()
    tiles = doc["meta"]["tiles"]
    assert tiles["auto"] is True
    assert tiles["batch_size"] == ws.tuned.batch_size
    assert tiles["permute_reduce_plain_chunk"] <= 30 * 29 // 2 + 7
    assert doc["meta"]["tune"]["n"] == 30
    assert doc["meta"]["tune"]["budget"]["backend"] == "cpu"
    json.dumps(doc)
    ws2 = Workspace(dm, config=CPU)
    doc2 = ws2.report().to_dict()
    assert doc2["meta"]["tiles"]["auto"] is False
    assert "tune" not in doc2["meta"]
    assert ws2.config_requested is ws2.config


def test_workspace_refresh_resolves_for_new_n():
    ws = Workspace(_dm(1, 24), config=AUTO)
    t1 = dataclasses.replace(ws.tuned)
    ws.refresh(dm=_dm(2, 120))
    assert ws.tuned.n == 120 and t1.n == 24
    assert ws.config_requested.auto
    assert not ws.config.auto
    wf = Workspace.from_features(_features(3), config=AUTO)
    assert wf.tuned.d == 12
    wf.refresh(features=_features(4, n=40, d=5))
    assert (wf.tuned.n, wf.tuned.d) == (40, 5)


def test_engine_charges_the_cpu_model_on_the_cpu():
    """A CPU session's ledger prices its tiles with the reference's
    condensed model; the card's row-stationary model is charged on the
    card (``tests/test_torch_cuda.py``)."""
    from repro_torch.obs import ObsConfig
    ws = Workspace(_dm(1, 24), config=ExecConfig(
        device="cpu", obs=ObsConfig(enabled=True)))
    ws.mantel(_dm(2, 24), permutations=40, key=1)
    entry = [e for e in ws.obs.ledger.entries if e.op == "perm:mantel"][0]
    assert entry.params["model"] == "condensed_fused"
    assert entry.floats == perm_traffic_floats(24, 32)["condensed_fused"] \
        * 64
    assert HOIST_PASSES["condensed"] == 1.0
