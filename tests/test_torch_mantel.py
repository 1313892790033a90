"""Port parity: the Mantel test and the permutation engine.

The reference's orders (``engine.permutation_orders`` of threefry bits,
which torch cannot draw) are passed in through ``orders=``. With the same
orders the exceedance counts and p-values must be equal, and the
statistic and null draws agree to 1e-5 (the reference reduces in fp32,
the port in fp64).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.core.distance_matrix import DistanceMatrix as JaxDM
from repro.core.mantel import MantelStatistic as JaxMantel
from repro.stats import engine as jax_engine
from repro_torch.core.distance_matrix import DistanceMatrix, condensed_form
from repro_torch.stats import engine

# the packages export a function named ``mantel`` over the module's name
jax_mantel_mod = importlib.import_module("repro.core.mantel")
mantel_mod = importlib.import_module("repro_torch.core.mantel")


def _pair(n, coupling, seed):
    """Two valid distance matrices; ``coupling`` sets how alike they are."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 4))
    other = coupling * pts + (1 - coupling) * rng.normal(size=(n, 4))
    mats = []
    for p in (pts, other):
        d = np.sqrt(((p[:, None] - p[None]) ** 2).sum(-1)).astype(np.float32)
        d = 0.5 * (d + d.T)
        np.fill_diagonal(d, 0.0)
        mats.append(d)
    return mats


def _ref_orders(permutations, n, seed=0):
    return np.array(jax_engine.permutation_orders(
        jax.random.PRNGKey(seed), permutations, n))


@pytest.mark.parametrize("n,coupling,permutations", [
    (61, 0.3, 99), (61, 0.05, 99), (61, 0.9, 99)])     # one reference compile
@pytest.mark.parametrize("alternative", ["two-sided", "greater", "less"])
def test_mantel_matches_reference_with_its_orders(n, coupling, permutations,
                                                  alternative):
    x, y = _pair(n, coupling, seed=n)
    want = jax_mantel_mod.mantel(JaxDM(jnp.asarray(x)), JaxDM(jnp.asarray(y)),
                                 permutations=permutations,
                                 alternative=alternative)
    got = mantel_mod.mantel(DistanceMatrix(x, device="cpu"),
                            DistanceMatrix(y, device="cpu"),
                            permutations=permutations,
                            alternative=alternative,
                            orders=torch.from_numpy(_ref_orders(permutations,
                                                                n)),
                            device="cpu")
    assert abs(got[0] - float(want[0])) <= 1e-5
    assert got[1] == want[1]               # same exceedance count, same fp32 p
    assert got[2] == want[2] == n


def test_null_draws_match_reference():
    n, permutations = 45, 70
    x, y = _pair(n, 0.4, seed=3)
    jstat = JaxMantel(jnp.asarray(x), jnp.asarray(y), n)
    observed, permuted = jax_engine._null_distribution(
        jstat, jax.random.PRNGKey(0), permutations, 32)
    stat = mantel_mod.MantelStatistic(torch.from_numpy(x),
                                      torch.from_numpy(y), n)
    inv, got_obs = engine.hoist_and_observe(stat, torch.device("cpu"))
    got = engine.null_distribution(
        stat, inv, torch.from_numpy(_ref_orders(permutations, n)), 32)
    assert abs(float(got_obs) - float(observed)) <= 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(permuted), rtol=1e-5,
                               atol=1e-5)
    # per_perm is the same function as one column of per_batch
    order = torch.from_numpy(_ref_orders(1, n, seed=4)[0])
    np.testing.assert_allclose(
        float(stat.per_perm(inv, order)),
        float(stat.per_batch(inv, order[None, :])[0]), rtol=1e-5, atol=1e-6)


def test_hoisted_moments_match_reference():
    x, y = _pair(30, 0.5, seed=5)
    want = jax_mantel_mod.condensed_moments(jnp.asarray(y), 30)
    got = mantel_mod.condensed_moments(torch.from_numpy(y), 30)
    np.testing.assert_allclose(float(got["norm"]), float(want["norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["hat"].numpy(), np.asarray(want["hat"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        float(mantel_mod.pearsonr_ref(condensed_form(torch.from_numpy(x)),
                                      condensed_form(torch.from_numpy(y)))),
        float(jax_mantel_mod.pearsonr_ref(
            JaxDM(jnp.asarray(x)).condensed_form(),
            JaxDM(jnp.asarray(y)).condensed_form())), rtol=1e-5)


def test_eager_mantel_ref_matches_reference():
    n, permutations = 20, 9
    x, y = _pair(n, 0.5, seed=6)
    want = jax_mantel_mod.mantel_ref(JaxDM(jnp.asarray(x)),
                                     JaxDM(jnp.asarray(y)), permutations)
    got = mantel_mod.mantel_ref(DistanceMatrix(x, device="cpu"),
                                DistanceMatrix(y, device="cpu"), permutations,
                                orders=torch.from_numpy(
                                    _ref_orders(permutations, n)))
    assert abs(got[0] - float(want[0])) <= 1e-5 and got[1] == want[1]


@pytest.mark.parametrize("count", [0, 1, 17, 999])
def test_finish_divides_like_reference(count):
    permuted = torch.cat([torch.full((count,), 2.0),
                          torch.zeros(999 - count)])
    want = jax_engine.finish(jnp.float32(1.0), jnp.asarray(permuted.numpy()),
                             999, "two-sided", 10)
    got = engine.finish(torch.tensor(1.0), permuted, 999, "two-sided", 10)
    assert got.p_value == want.p_value and got.statistic == want.statistic
    nan = engine.finish(torch.tensor(float("nan")), permuted, 999,
                        "greater", 10)
    assert np.isnan(nan.p_value)


def test_orders_are_seeded_permutations_and_tiles_do_not_matter():
    a = engine.permutation_orders(3, 50, 37)
    assert a.dtype == torch.int32 and a.shape == (50, 37)
    assert torch.equal(torch.sort(a, dim=1).values,
                       torch.arange(37, dtype=torch.int32).expand(50, 37))
    assert torch.equal(a, engine.permutation_orders(3, 50, 37))
    assert not torch.equal(a, engine.permutation_orders(4, 50, 37))
    x, y = _pair(37, 0.2, seed=7)
    stat = mantel_mod.MantelStatistic(torch.from_numpy(x),
                                      torch.from_numpy(y), 37)
    inv = stat.hoist()
    by8 = engine.null_distribution(stat, inv, a, 8)
    by32 = engine.null_distribution(stat, inv, a, 32)
    np.testing.assert_array_equal(by8.numpy(), by32.numpy())


def test_engine_rejects_bad_arguments():
    x, y = _pair(12, 0.5, seed=8)
    stat = mantel_mod.MantelStatistic(torch.from_numpy(x),
                                      torch.from_numpy(y), 12)
    with pytest.raises(ValueError, match="alternative"):
        engine.permutation_test(stat, 9, alternative="both", device="cpu")
    with pytest.raises(ValueError, match="orders must be"):
        engine.permutation_test(stat, 9, orders=torch.zeros(8, 12),
                                device="cpu")
    with pytest.raises(ValueError, match="indices"):
        engine.permutation_test(stat, 2, orders=torch.full((2, 12), 12),
                                device="cpu")
    with pytest.raises(ValueError, match="same shape"):
        mantel_mod.mantel(DistanceMatrix(x, device="cpu"),
                          DistanceMatrix(y[:5, :5], device="cpu"),
                          device="cpu")
    r = engine.permutation_test(stat, 0, device="cpu")
    assert r.p_value == 1.0 and r.permutations == 0


def _run_test(method, k, key, orders=None, b=32, n=40):
    """``(result, null)`` of one ``Workspace`` test over the ``_pair``
    squares (the null as ``engine.finish`` receives it)."""
    from repro_torch.api import ExecConfig, Workspace
    x, y = _pair(n, 0.3, seed=11)
    ws = Workspace(DistanceMatrix(x, device="cpu"),
                   config=ExecConfig(device="cpu", batch_size=b))
    grouping = np.arange(n) % 3
    call = {"mantel": lambda **kw: ws.mantel(DistanceMatrix(y, device="cpu"),
                                             **kw),
            "permanova": lambda **kw: ws.permanova(grouping, **kw),
            "anosim": lambda **kw: ws.anosim(grouping, **kw)}[method]
    nulls = []
    finish = engine.finish

    def keep(orig, permuted, *args, **kwargs):
        nulls.append(permuted.clone())
        return finish(orig, permuted, *args, **kwargs)

    engine.finish = keep
    try:
        result = call(permutations=k, key=key, orders=orders)
    finally:
        engine.finish = finish
    return result, nulls[0]


@pytest.mark.parametrize("k,n,b", [(999, 40, 32), (99, 40, 32),
                                   (17, 40, 32), (64, 40, 32), (0, 40, 32)])
@pytest.mark.parametrize("method", ["mantel", "permanova", "anosim"])
@pytest.mark.parametrize("keyed", ["int", "generator"])
def test_streamed_orders_are_the_whole_draw_bit_for_bit(k, n, b, method,
                                                        keyed):
    """A test that draws its own orders a tile ahead gives the null and
    p-value of the same test given ``permutation_orders(key, K, n)``, and
    leaves a generator key where the whole draw leaves it."""
    if keyed == "int":
        key, whole = 5, engine.permutation_orders(5, k, n)
    else:
        key = torch.Generator().manual_seed(5)
        drawn = torch.Generator().manual_seed(5)
        whole = engine.permutation_orders(drawn, k, n)
    got, got_null = _run_test(method, k, key, b=b, n=n)
    want, want_null = _run_test(method, k, None, orders=whole, b=b, n=n)
    assert got_null.shape == (k,)
    assert torch.equal(got_null, want_null)
    assert got.p_value == want.p_value or (
        np.isnan(got.p_value) and np.isnan(want.p_value))
    assert got.statistic == want.statistic
    if keyed == "generator":
        assert torch.equal(key.get_state(), drawn.get_state())


@pytest.mark.parametrize("k,n,b", [(999, 40, 32), (99, 40, 32),
                                   (17, 40, 32), (64, 40, 32), (5, 40, 32),
                                   (0, 40, 32)])
def test_order_stream_tiles_are_the_wrapped_whole_draw(k, n, b):
    """Padded tile t of the stream is rows ``[tB, (t + 1)B)`` of the whole
    draw wrapped to full tiles, the last tile's padding from tile 0."""
    whole = engine.permutation_orders(9, k, n)
    tiles = -(-k // b)
    wrapped = whole[torch.arange(tiles * b) % k] if k else whole
    stream = engine.OrderStream(9, k, n, b, torch.device("cpu"))
    stream.first()
    for t in range(tiles):
        if t:
            stream.ahead(t)
        assert torch.equal(stream.tile(t), wrapped[t * b:(t + 1) * b])
    assert stream.drawn_ahead == max(tiles - 1, 0)
