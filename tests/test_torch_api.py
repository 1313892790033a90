"""Port parity of the session API: ``repro_torch.api`` against ``repro.api``.

The cases of ``tests/test_api.py``, each run through the reference's
``Workspace`` and through the port's on the CPU, on the same numpy
inputs. The port's seeds draw other numbers than JAX's keys, so the
reference's permutation orders and fsvd sketch are passed in (``orders=``,
``omega=``). Statistics agree to the reference's 1e-5 (PERMDISP
1e-4·max(|s|, 1)), p-values are equal, and the HoistCache hit/miss
counters are equal after the same call sequence (coords keys compared by
artifact, dimensions and method: the sketch fingerprints differ by
construction). Within the port, a session and the free functions are
bitwise equal on the same orders and sketch.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.api import ExecConfig as JaxExecConfig
from repro.api import Workspace as JaxWorkspace
from repro.core import DistanceMatrix as JaxDistanceMatrix
from repro.stats.engine import permutation_orders as jax_orders
from repro_torch.api import ExecConfig, HoistCache, Workspace
from repro_torch.api import config as config_mod
from repro_torch.core import (CenteredGramOperator, DistanceMatrix, mantel,
                              pcoa)
from repro_torch.core.distance_matrix import as_generator
from repro_torch.core.pcoa import (materialized_gram, resolve_dimensions,
                                   sketch_width)
from repro_torch.dist import METRICS
from repro_torch.obs import ObsConfig
from repro_torch.stats import (anosim, partial_mantel, permanova, permdisp,
                               permutation_orders)
from repro_torch.stats.partial_mantel import (PartialMantelPallasStatistic,
                                              PartialMantelStatistic)

KEY = jax.random.PRNGKey(7)
N = 36
CPU = ExecConfig(device="cpu")


def _dm(seed, n=N):
    """A valid distance matrix from numpy: Euclidean distances of n
    points in 8 dimensions, exactly symmetric and hollow in fp32."""
    pts = np.random.default_rng(seed).normal(size=(n, 8))
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    d = 0.5 * (d + d.T)
    np.fill_diagonal(d, 0.0)
    return d.astype(np.float32)


def _grouping(n=N, k=3):
    return np.array([i % k for i in range(n)])


def _features(seed, n=30, d=7):
    return np.abs(np.random.default_rng(seed).normal(size=(n, d))).astype(
        np.float32)


def _orders(k, n=N, key=KEY):
    return torch.from_numpy(np.array(jax_orders(key, k, n)))


def _omega(k, n=N):
    """The sketch the reference's pcoa draws at its default seed 42."""
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(42), (n, sketch_width(k, n)))))


def _norm(counter):
    """Cache counters keyed by artifact (and, for coords, dimensions and
    method): the sketch fingerprints differ by construction."""
    return {(k if isinstance(k, str) else tuple(k[:3])): v
            for k, v in counter.items()}


def _same_counters(port_cache, ref_cache):
    assert _norm(port_cache.misses) == _norm(ref_cache.misses)
    assert _norm(port_cache.hits) == _norm(ref_cache.hits)


def _close(got, want, name=""):
    tol = 1e-4 * max(abs(want.statistic), 1.0) if name == "permdisp" \
        else 1e-5
    assert abs(got.statistic - float(want.statistic)) <= tol, name
    assert got.p_value == float(want.p_value), name


# --------------------------------------------------------------------------
# golden parity: Workspace-routed == standalone, bitwise, same orders
# --------------------------------------------------------------------------
def test_workspace_matches_standalone_bitwise():
    """The session changes how often D is read, never the answer: bitwise
    the free functions' results on the same orders and sketch, and the
    reference's within its tolerances."""
    d, d2, d3, g = _dm(0), _dm(1), _dm(2), _grouping()
    o, om = _orders(49), _omega(5)
    ws = Workspace(d, config=CPU)
    got = {"permanova": ws.permanova(g, 49, orders=o),
           "permdisp": ws.permdisp(g, 49, dimensions=5, orders=o, omega=om),
           "anosim": ws.anosim(g, 49, orders=o),
           "mantel": ws.mantel(d2, 49, orders=o),
           "partial_mantel": ws.partial_mantel(d2, d3, 49, orders=o)}
    w_pcoa = ws.pcoa(dimensions=5, omega=om)

    x, y, z = (DistanceMatrix(torch.from_numpy(m), device="cpu")
               for m in (d, d2, d3))
    s_pcoa = pcoa(x, dimensions=5, omega=om, device="cpu")
    free = {"permanova": permanova(x, g, 49, orders=o, device="cpu"),
            "permdisp": permdisp(x, g, 49, dimensions=5, orders=o,
                                 omega=om, device="cpu"),
            "anosim": anosim(x, g, 49, orders=o, device="cpu"),
            "partial_mantel": partial_mantel(x, y, z, 49, orders=o,
                                             device="cpu")}
    assert torch.equal(w_pcoa.coordinates, s_pcoa.coordinates)
    assert torch.equal(w_pcoa.eigenvalues, s_pcoa.eigenvalues)
    for name, s in free.items():
        assert (got[name].statistic, got[name].p_value) == \
            (s.statistic, s.p_value), name
    m = got["mantel"]
    assert (m.statistic, m.p_value, m.sample_size) == \
        mantel(x, y, 49, orders=o, device="cpu")

    ref = JaxWorkspace(d)
    want = {"permanova": ref.permanova(g, 49, key=KEY),
            "permdisp": ref.permdisp(g, 49, key=KEY, dimensions=5),
            "anosim": ref.anosim(g, 49, key=KEY),
            "mantel": ref.mantel(d2, 49, key=KEY),
            "partial_mantel": ref.partial_mantel(d2, d3, 49, key=KEY)}
    for name, w in want.items():
        _close(got[name], w, name)
    np.testing.assert_allclose(w_pcoa.eigenvalues.numpy(),
                               np.asarray(ref.pcoa(dimensions=5).eigenvalues),
                               rtol=1e-4)


def test_workspace_hoists_run_once():
    """pcoa + permanova + permdisp + anosim on one session builds each
    O(n²) hoist at most once, repeats are pure hits, and the counters are
    the reference's after the same calls."""
    d, g = _dm(3), _grouping()
    o, om = _orders(19), _omega(5)
    ws, ref = Workspace(d, config=CPU), JaxWorkspace(d)
    ws.pcoa(dimensions=5, omega=om)
    ws.permanova(g, 19, orders=o)
    ws.permdisp(g, 19, dimensions=5, orders=o, omega=om)
    ws.anosim(g, 19, orders=o)
    ref.pcoa(dimensions=5)
    ref.permanova(g, 19, key=KEY)
    ref.permdisp(g, 19, key=KEY, dimensions=5)
    ref.anosim(g, 19, key=KEY)
    _same_counters(ws.cache, ref.cache)
    for artifact in ("operator", "gram", "ranks"):
        assert ws.cache.build_count(artifact) <= 1, artifact
    assert ws.cache.build_count("coords") == 1      # permdisp reused pcoa's

    before = dict(ws.cache.misses)
    ws.permanova(g, 19, orders=o)
    ws.anosim(g, 19, orders=o)
    ws.pcoa(dimensions=5, omega=om)
    ref.permanova(g, 19, key=KEY)
    ref.anosim(g, 19, key=KEY)
    ref.pcoa(dimensions=5)
    assert dict(ws.cache.misses) == before
    assert ws.cache.hits["gram"] >= 1 and ws.cache.hits["ranks"] >= 1
    _same_counters(ws.cache, ref.cache)


def test_hoist_cache_counters():
    c = HoistCache()
    assert c.get("a", lambda: 41) == 41
    assert c.get("a", lambda: 99) == 41              # cached, not rebuilt
    assert c.counts("a") == (1, 1)
    assert c.build_count("a") == 1
    assert ("a" in c) and len(c) == 1
    c.get(("coords", 3), lambda: "x")
    c.get(("coords", 5), lambda: "y")
    assert c.build_count("coords") == 2


def test_workspace_mantel_shares_both_sides():
    """Both operands' moments come from their own session caches, no
    session builds a square artifact, and every session's counters are
    the reference's."""
    mats = [_dm(4), _dm(5), _dm(6)]
    o = _orders(19)
    x, y, z = (Workspace(m, config=CPU) for m in mats)
    rx, ry, rz = (JaxWorkspace(m) for m in mats)
    x.mantel(y, 19, orders=o)
    x.mantel(z, 19, orders=o)
    x.partial_mantel(y, z, 19, orders=o)
    rx.mantel(ry, 19, key=KEY)
    rx.mantel(rz, 19, key=KEY)
    rx.partial_mantel(ry, rz, 19, key=KEY)
    for ws, ref in ((x, rx), (y, ry), (z, rz)):
        assert ws.cache.build_count("moments") == 1
        assert ws.cache.build_count("condensed") == 1
        assert ws.cache.build_count("square") == 0
        _same_counters(ws.cache, ref.cache)
    assert x.cache.counts("moments")[0] >= 2


def test_workspace_mantel_family_square_free_on_features():
    """The whole battery on a feature-backed session builds no
    ``"square"``: the statistics are the reference's, and so are the
    counters of all three sessions."""
    tables = [_features(s) for s in (50, 51, 52)]
    g = _grouping(30)
    o, om = _orders(19, 30), _omega(3, 30)
    ws, ws_y, ws_z = (Workspace.from_features(t, metric="braycurtis",
                                              config=CPU) for t in tables)
    ref, ref_y, ref_z = (JaxWorkspace.from_features(t, metric="braycurtis")
                         for t in tables)
    got = {"pcoa": ws.pcoa(dimensions=3, omega=om),
           "permanova": ws.permanova(g, 19, orders=o),
           "permdisp": ws.permdisp(g, 19, dimensions=3, orders=o, omega=om),
           "anosim": ws.anosim(g, 19, orders=o),
           "mantel": ws.mantel(ws_y, 19, orders=o),
           "partial_mantel": ws.partial_mantel(ws_y, ws_z, 19, orders=o)}
    want = {"pcoa": ref.pcoa(dimensions=3),
            "permanova": ref.permanova(g, 19, key=KEY),
            "permdisp": ref.permdisp(g, 19, key=KEY, dimensions=3),
            "anosim": ref.anosim(g, 19, key=KEY),
            "mantel": ref.mantel(ref_y, 19, key=KEY),
            "partial_mantel": ref.partial_mantel(ref_y, ref_z, 19, key=KEY)}
    np.testing.assert_allclose(got.pop("pcoa").eigenvalues.numpy(),
                               np.asarray(want.pop("pcoa").eigenvalues),
                               rtol=1e-4)
    for name, w in want.items():
        _close(got[name], w, name)
    for w, r in ((ws, ref), (ws_y, ref_y), (ws_z, ref_z)):
        assert w.cache.build_count("square") == 0
        assert w._dm is None                        # never even wrapped one
        _same_counters(w.cache, r.cache)


# --------------------------------------------------------------------------
# ExecConfig
# --------------------------------------------------------------------------
def test_execconfig_validates():
    with pytest.raises(ValueError):
        ExecConfig(matvec_impl="cuda")
    with pytest.raises(ValueError):
        ExecConfig(centering_impl="bogus")
    with pytest.raises(ValueError):
        ExecConfig(kernel="cuda")
    with pytest.raises(ValueError):
        ExecConfig(batch_size=0)
    with pytest.raises(ValueError):
        ExecConfig(block=0)
    with pytest.raises(ValueError):
        ExecConfig(metric="cosine")
    with pytest.raises(ValueError):
        ExecConfig(device="meta")
    cfg = ExecConfig(block=128).replace(batch_size=16)
    assert cfg.block == 128 and cfg.batch_size == 16
    assert cfg.resolve_batch_size(None, 32) == 16    # config beats default
    assert cfg.resolve_batch_size(4, 32) == 4        # explicit beats config
    assert ExecConfig().resolve_batch_size(None, 32) == 32
    # hashable by value, as the reference's leaf-free pytree is
    assert hash(cfg) == hash(ExecConfig(block=128, batch_size=16))
    assert ExecConfig(device="cpu") == ExecConfig(device="cpu")
    # the reference's field names and defaults carry across
    ref = {f.name: getattr(JaxExecConfig(), f.name)
           for f in dataclasses.fields(JaxExecConfig) if f.name != "obs"}
    port = {f.name: getattr(ExecConfig(), f.name)
            for f in dataclasses.fields(ExecConfig) if f.name != "obs"}
    assert port == ref
    assert set(config_mod._KNOWN_METRICS) == set(METRICS)


@pytest.mark.parametrize("changes,what", [
    ({"mesh": object()}, "mesh"),
    ({"centering_impl": "distributed"}, "distributed"),
])
def test_execconfig_refuses_what_is_not_ported(changes, what):
    """The reference's rule for the distributed paths (``config.py:192``):
    ``"distributed"`` without a mesh raises ``ValueError``; a config with a
    mesh is accepted, and resolves like any other."""
    if what == "distributed":
        with pytest.raises(ValueError, match="requires a mesh") as err:
            ExecConfig(**changes)
        with pytest.raises(ValueError, match="requires a mesh"):
            JaxExecConfig(**changes)
        assert what in str(err.value)
    else:
        cfg = ExecConfig(**changes, centering_impl="distributed")
        assert cfg.mesh is changes["mesh"]
        assert cfg.resolve(64) == (cfg, None)
        resolved, tuned = cfg.replace(auto=True, device="cpu").resolve(64)
        assert resolved.mesh is changes["mesh"] and tuned is not None


def test_execconfig_threads_through_pallas_paths():
    """The reference's kernel choices are accepted; on the CPU each runs
    the plain version, so the answers are the default route's, bitwise,
    and ``kernel="pallas"`` names ``PartialMantelPallasStatistic``."""
    d, g = _dm(8, 24), _grouping(24)
    y, z = _dm(9, 24), _dm(10, 24)
    o, om = _orders(19, 24), _omega(3, 24)
    cfg = ExecConfig(matvec_impl="pallas", kernel="pallas",
                     pairwise_impl="pallas", interpret=True, chunk=64,
                     block=32, device="cpu")
    ws, ws_x = Workspace(d, config=cfg), Workspace(d, config=CPU)
    a = ws.pcoa(dimensions=3, omega=om)
    b = ws_x.pcoa(dimensions=3, omega=om)
    assert torch.equal(a.coordinates, b.coordinates)
    pm = ws.partial_mantel(y, z, 19, orders=o)
    pm_x = ws_x.partial_mantel(y, z, 19, orders=o)
    assert (pm.statistic, pm.p_value) == (pm_x.statistic, pm_x.p_value)
    stat, _ = ws.statistic("partial_mantel", other=y, control=z)
    assert type(stat) is PartialMantelPallasStatistic
    assert isinstance(stat, PartialMantelStatistic)
    stat, _ = ws_x.statistic("partial_mantel", other=y, control=z)
    assert type(stat) is PartialMantelStatistic
    ref = JaxWorkspace(d, config=JaxExecConfig(
        matvec_impl="pallas", kernel="pallas", block=32))
    _close(pm, ref.partial_mantel(y, z, 19, key=KEY))


def test_workspace_canonicalizes_and_validates():
    raw = _dm(11).astype(np.float64)
    ws = Workspace(raw, config=CPU)                  # raw array accepted
    assert ws.data.dtype == torch.float32            # canonical fp32
    assert ws.data.device.type == "cpu" and ws.dm._validated
    with pytest.raises(Exception):
        Workspace(raw + np.eye(N), config=CPU)       # non-hollow rejected
    with pytest.raises(ValueError, match="non-finite"):
        Workspace(np.full((4, 4), np.nan), config=CPU)
    with pytest.raises(ValueError):
        Workspace(_dm(11), config=CPU).mantel(_dm(12, 20))  # shape mismatch
    with pytest.raises(ValueError):
        Workspace(_dm(11), config=CPU).permanova(_grouping(12))
    with pytest.raises(ValueError, match="OR"):
        Workspace(raw, config=CPU, features=_features(1))


def test_workspace_validate_false_is_consistent():
    """validate=False admits the matrix once for the whole session; an
    unvalidated DistanceMatrix is validated by a session unless it opts
    out, while the free functions trust it as constructed."""
    bad = _dm(20, 16).copy()
    bad[0, 1] += 0.5                                 # asymmetric on purpose
    ws = Workspace(bad, config=CPU, validate=False)
    assert ws.dm._validated                          # trusted once admitted
    ws.pcoa(dimensions=3)                            # copy() must not raise
    with pytest.raises(Exception):
        Workspace(bad, config=CPU)                   # default still rejects
    bad_dm = DistanceMatrix(torch.from_numpy(bad), validate=False,
                            device="cpu")
    with pytest.raises(Exception):
        Workspace(bad_dm, config=CPU)
    assert Workspace(bad_dm, config=CPU, validate=False).dm._validated
    r = permanova(bad_dm, _grouping(16), 9, device="cpu")
    assert 0.0 < r.p_value <= 1.0
    ref = JaxWorkspace(JaxDistanceMatrix(bad, validate=False), validate=False)
    assert ref.dm._validated


def test_workspace_collinear_control_raises():
    x, y = _dm(13), _dm(14)
    with pytest.raises(ValueError, match="collinear"):
        Workspace(x, config=CPU).partial_mantel(y, y, permutations=9)
    with pytest.raises(ValueError, match="collinear"):
        JaxWorkspace(x).partial_mantel(y, y, permutations=9)


# --------------------------------------------------------------------------
# RNG handling (the port's seeds are not JAX keys; its own rule is pinned)
# --------------------------------------------------------------------------
def test_as_key_coercion_rule():
    """The port's one coercion rule, ``as_generator``: ``None`` is the
    entry point's default seed, an int (numpy too) a seed, a generator
    passes through."""
    def draw(gen):
        return torch.randint(0, 2**31, (8,), generator=gen)

    assert torch.equal(draw(as_generator(None, default=5)),
                       draw(torch.Generator().manual_seed(5)))
    assert torch.equal(draw(as_generator(7)),
                       draw(torch.Generator().manual_seed(7)))
    assert torch.equal(draw(as_generator(np.int64(7))),
                       draw(torch.Generator().manual_seed(7)))
    gen = torch.Generator()
    assert as_generator(gen) is gen


def test_int_seed_equals_key_everywhere():
    """``key=7`` and a generator seeded 7 draw identical permutations and
    sketches in every entry point."""
    d, d2, g = _dm(15), _dm(16), _grouping()
    x, y = (DistanceMatrix(torch.from_numpy(m), device="cpu")
            for m in (d, d2))

    def seeded():
        return torch.Generator().manual_seed(7)

    assert permanova(x, g, 19, 7, device="cpu") == \
        permanova(x, g, 19, seeded(), device="cpu")
    assert anosim(x, g, 19, 7, device="cpu") == \
        anosim(x, g, 19, seeded(), device="cpu")
    assert mantel(x, y, 19, 7, device="cpu") == \
        mantel(x, y, 19, seeded(), device="cpu")
    a = pcoa(x, dimensions=3, key=7, device="cpu")
    b = pcoa(x, dimensions=3, key=seeded(), device="cpu")
    assert torch.equal(a.coordinates, b.coordinates)
    assert torch.equal(permutation_orders(7, 19, N),
                       permutation_orders(seeded(), 19, N))


def test_results_record_method_and_key():
    d, g = _dm(17), _grouping()
    ws = Workspace(d, config=CPU)
    r = ws.permanova(g, permutations=19, key=7)
    assert r.method == "permanova" and r.key == 7
    assert ws.permanova(g, permutations=19).key == 0    # the engine's default
    o = ws.pcoa(dimensions=3)
    assert o.method == "fsvd" and o.key == 42           # the solver's default
    assert ws.pcoa(dimensions=3, method="eigh").key is None  # deterministic
    assert dataclasses.is_dataclass(r) and dataclasses.is_dataclass(o)


def test_generator_keyed_pcoa_is_never_cached():
    """A generator's draw depends on its state, which each solve advances:
    two calls with one generator draw two sketches, as the free ``pcoa``
    does, and no ``coords`` entry holds a generator's solve. Int seeds
    and given sketches are cached by their values."""
    d = _dm(25)
    ws = Workspace(d, config=CPU)
    x = DistanceMatrix(torch.from_numpy(d), device="cpu")
    gen, free_gen = (torch.Generator().manual_seed(3) for _ in range(2))
    first = ws.pcoa(dimensions=3, key=gen)
    second = ws.pcoa(dimensions=3, key=gen)
    assert torch.equal(first.coordinates, pcoa(
        x, dimensions=3, key=free_gen, device="cpu").coordinates)
    assert torch.equal(second.coordinates, pcoa(
        x, dimensions=3, key=free_gen, device="cpu").coordinates)
    assert not torch.equal(first.coordinates, second.coordinates)
    assert ws.cache.build_count("coords") == 0
    assert ws.cache.build_count("operator") == 1    # the hoist is shared
    seeded = ws.pcoa(dimensions=3, key=3)
    assert torch.equal(seeded.coordinates, first.coordinates)
    assert ws.pcoa(dimensions=3, key=3) is seeded   # an int seed: cached
    om = _omega(3)
    a = ws.pcoa(dimensions=3, omega=om)
    assert ws.pcoa(dimensions=3, omega=om.clone()) is a   # same values
    assert ws.pcoa(dimensions=3, omega=om + 1e-3) is not a
    assert ws.cache.build_count("coords") == 3


def test_cache_nbytes_counts_shared_buffers_once():
    """A feature-backed session's operator references the condensed
    tensor and the production's means: it is charged nothing over them;
    the total counts every storage once."""
    ws = Workspace.from_features(_features(40), config=CPU)
    ws.pcoa(dimensions=3)
    by_key = ws.cache.nbytes_by_key()
    m = 30 * 29 // 2
    assert by_key["condensed"] == 4 * m
    assert by_key["operator"] == 0
    assert ws.cache.nbytes("operator") >= 4 * m     # its full reachable set
    assert ws.cache.nbytes() == sum(by_key.values())
    coords = ws.pcoa(dimensions=3).coordinates
    assert by_key[("coords", 3, "fsvd", 42)] >= coords.numel() * 4


def test_resolved_tiles_report_the_cpu_geometry():
    ws = Workspace.from_features(_features(41), config=ExecConfig(
        device="cpu", batch_size=16, block=8))
    tiles = ws.report().meta["tiles"]
    assert tiles == {"device": "cpu", "batch_size": 16, "auto": False,
                     "production_panel_rows": 8,
                     "production_route": {"route": "dense",
                                          "nonzero_share": 1.0, "nnz": 210,
                                          "max_row": 7},
                     "permute_reduce_plain_chunk": 440}


# --------------------------------------------------------------------------
# pcoa dimensions validation
# --------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["fsvd", "eigh"])
def test_pcoa_dimensions_validation_consistent(method):
    """``dimensions <= 0`` raises and ``dimensions > n`` clamps to n on
    both solver paths, through the session and the free functions."""
    d = _dm(18, 20)
    dm = DistanceMatrix(torch.from_numpy(d), device="cpu")
    for bad in (0, -3):
        with pytest.raises(ValueError, match="dimensions"):
            pcoa(dm, dimensions=bad, method=method, device="cpu")
        with pytest.raises(ValueError, match="dimensions"):
            Workspace(d, config=CPU).pcoa(dimensions=bad, method=method)
    r = pcoa(dm, dimensions=55, method=method, device="cpu")
    assert r.coordinates.shape == (20, 20)
    assert Workspace(d, config=CPU).pcoa(
        dimensions=55, method=method).coordinates.shape == (20, 20)
    with pytest.raises(ValueError, match="dimensions"):
        permdisp(dm, _grouping(20), permutations=9, dimensions=-1,
                 device="cpu")


def test_pcoa_rejects_mismatched_prebuilt_artifacts():
    """A prebuilt hoist the taken path would ignore is an error."""
    dm = DistanceMatrix(torch.from_numpy(_dm(19, 16)), device="cpu")
    op = CenteredGramOperator.from_distance(dm.data)
    g = materialized_gram(dm.data)
    with pytest.raises(ValueError, match="gram"):
        pcoa(dm, dimensions=3, gram=g, device="cpu")    # runs matrix-free
    with pytest.raises(ValueError, match="operator"):
        pcoa(dm, dimensions=3, method="eigh", operator=op, device="cpu")
    a = pcoa(dm, dimensions=3, operator=op, device="cpu")
    b = pcoa(dm, dimensions=3, device="cpu")
    assert torch.equal(a.coordinates, b.coordinates)
    e1 = pcoa(dm, dimensions=3, method="eigh", gram=g, device="cpu")
    e2 = pcoa(dm, dimensions=3, method="eigh", device="cpu")
    assert torch.equal(e1.eigenvalues, e2.eigenvalues)


def test_resolve_dimensions_rule():
    assert resolve_dimensions(None, 10) == 9         # scikit-bio: all axes
    assert resolve_dimensions(3, 10) == 3
    assert resolve_dimensions(99, 10) == 10          # clamp
    assert resolve_dimensions(None, 1) == 1          # degenerate floor
    for bad in (0, -1):
        with pytest.raises(ValueError):
            resolve_dimensions(bad, 10)


def test_hoist_counters_across_refresh_generations():
    """refresh() drops every artifact with fresh counters; the counters
    of each generation are the reference's after the same calls."""
    d, d2, g = _dm(11), _dm(12), _grouping()
    o = _orders(19)
    ws = Workspace(d, config=CPU)
    ref = JaxWorkspace(d)
    for _ in range(2):
        ws.permanova(g, 19, orders=o)
        ref.permanova(g, 19, key=KEY)
    gen0 = ws.cache
    assert ws.generation == 0 and gen0.counts("gram") == (1, 1)
    _same_counters(ws.cache, ref.cache)

    ws.refresh()
    ref.refresh()
    assert ws.generation == 1 and ws.cache is not gen0
    assert len(ws.cache) == 0 and ws.cache.counts("gram") == (0, 0)
    assert gen0.counts("gram") == (1, 1)             # old tallies untouched
    r0 = ws.permanova(g, 19, orders=o)
    r1 = ws.permanova(g, 19, orders=o)
    ref.permanova(g, 19, key=KEY)
    ref.permanova(g, 19, key=KEY)
    assert ws.cache.counts("gram") == (1, 1) and r0 == r1
    _same_counters(ws.cache, ref.cache)

    ws.refresh(dm=d2)
    ref.refresh(dm=d2)
    assert ws.generation == 2 and ws.cache.counts("gram") == (0, 0)
    ws.permanova(g, 19, orders=o)
    ref.permanova(g, 19, key=KEY)
    assert ws.cache.counts("gram") == (0, 1)
    _same_counters(ws.cache, ref.cache)

    # a feature-backed session re-produces after refresh(features=...)
    fs = Workspace.from_features(_features(60), config=CPU)
    fs.pcoa(dimensions=3)
    fs.refresh(features=_features(61))
    assert fs.cache.build_count("condensed") == 0
    fs.pcoa(dimensions=3)
    assert fs.cache.build_count("condensed") == 1 and fs.generation == 1


def test_eigh_coords_slice_hit_path_exact_counts():
    """A lower-k eigh request is served by slicing a cached higher-k
    solution: one hit on the higher-k entry, a slice-only build, no
    re-solve, and the slice is bitwise the solution's prefix; the counters
    are the reference's."""
    d = _dm(13)
    ws, ref = Workspace(d, config=CPU), JaxWorkspace(d)
    full = ws.pcoa(dimensions=8, method="eigh")
    ref.pcoa(dimensions=8, method="eigh")
    k8 = ("coords", 8, "eigh", None)
    assert ws.cache.counts(k8) == (0, 1)
    assert ws.cache.counts("gram") == (0, 1)

    low = ws.pcoa(dimensions=3, method="eigh")
    ref.pcoa(dimensions=3, method="eigh")
    k3 = ("coords", 3, "eigh", None)
    assert ws.cache.counts(k8) == (1, 1)
    assert ws.cache.counts(k3) == (0, 1)
    assert ws.cache.counts("gram") == (0, 1)
    assert torch.equal(low.coordinates, full.coordinates[:, :3])
    assert torch.equal(low.eigenvalues, full.eigenvalues[:3])

    ws.pcoa(dimensions=3, method="eigh")
    ref.pcoa(dimensions=3, method="eigh")
    assert ws.cache.counts(k3) == (1, 1) and ws.cache.counts(k8) == (1, 1)

    for k in (12, 6):
        ws.pcoa(dimensions=k, method="eigh")
        ref.pcoa(dimensions=k, method="eigh")
    assert ws.cache.counts(k8) == (2, 1)
    assert ws.cache.counts(("coords", 12, "eigh", None)) == (0, 1)
    _same_counters(ws.cache, ref.cache)
    np.testing.assert_allclose(
        full.eigenvalues.numpy(),
        np.asarray(ref.pcoa(dimensions=8, method="eigh").eigenvalues),
        rtol=1e-4)


def test_obs_enabled_session_answers_the_same():
    """Observability changes what is recorded, never the answer."""
    d, g = _dm(30), _grouping()
    o = _orders(19)
    on = Workspace(d, config=ExecConfig(device="cpu",
                                        obs=ObsConfig(enabled=True)))
    off = Workspace(d, config=CPU)
    assert on.permanova(g, 19, orders=o) == off.permanova(g, 19, orders=o)
    assert on.anosim(g, 19, orders=o) == off.anosim(g, 19, orders=o)


# --------------------------------------------------------------------------
# a session with a mesh (the cases of tests/test_api.py a mesh enables)
# --------------------------------------------------------------------------
def test_workspace_routes_gram_and_pcoa_through_a_mesh():
    """``ExecConfig(mesh=, centering_impl="distributed")``: the session's
    gram and pcoa run over the mesh, as the reference's over a one-device
    ``jax.sharding.Mesh``; on one rank the gram is the square path's,
    bitwise. Its tests stay on the single-process engine, as in the
    reference: the same answers as a session without a mesh."""
    from jax.sharding import Mesh
    from repro_torch.launch import make_host_mesh

    mesh = make_host_mesh((1, 1), device_type="cpu")
    jax_mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
    d = _dm(21)
    cfg = CPU.replace(mesh=mesh, centering_impl="distributed")
    ws = Workspace(DistanceMatrix(torch.from_numpy(d), device="cpu"),
                   config=cfg)
    ref = JaxWorkspace(JaxDistanceMatrix(d), config=JaxExecConfig(
        mesh=jax_mesh, centering_impl="distributed"))
    np.testing.assert_allclose(ws.gram().numpy(), np.asarray(ref.gram()),
                               rtol=2e-4, atol=2e-4)
    assert torch.equal(ws.gram(), materialized_gram(torch.from_numpy(d)))
    for method in ("eigh", "fsvd"):
        got = ws.pcoa(dimensions=4, method=method, omega=_omega(4))
        want = ref.pcoa(dimensions=4, method=method)
        np.testing.assert_allclose(got.eigenvalues.numpy(),
                                   np.asarray(want.eigenvalues), rtol=1e-4)
    assert ws.cache.misses["gram"] == 1
    single = Workspace(DistanceMatrix(torch.from_numpy(d), device="cpu"),
                       config=CPU)
    g = _grouping()
    a = ws.permanova(g, permutations=19, orders=_orders(19))
    b = single.permanova(g, permutations=19, orders=_orders(19))
    assert (a.statistic, a.p_value) == (b.statistic, b.p_value)
