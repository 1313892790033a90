"""Port parity: the row-stationary reformulation of the card's
``permute_reduce`` and ``mantel_corr`` kernels, on the CPU.

With π_b the inverse of order b, every pair i < j is counted once from the
side of x's row r = o_b[i]; the kernels walk x row by row, each row held
for all B permutations. Their plain versions walk the same way
(``permute_reduce_rows``, ``mantel_corr_rows``) and are held against the
reference on the reference's own orders: its ``permute_reduce`` (the
Pallas kernel in interpret mode, and its oracle) at rtol 1e-5 / atol 1e-5
(``tests/test_torch_permute_reduce.py``), and its ``mantel_corr`` (the
Pallas kernel in interpret mode over the pre-gathered squares, and the
Pearson r of ``mantel_corr_pallas``) at rtol 1e-4 / atol 1e-5
(``tests/test_torch_mantel_corr.py``; the raw sums with atol scaled by
max(scale, 1)). The inverse-order helper they share is exact, and refuses
an order row that is not a permutation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.kernels.mantel_corr import mantel_corr as jax_mantel_kernel
from repro.kernels.mantel_corr_ops import mantel_corr_pallas
from repro.kernels.permute_reduce_ops import permute_reduce as jax_reduce
from repro.kernels.permute_reduce_ref import permute_reduce_ref as jax_oracle
from repro.stats.engine import permutation_orders as jax_orders
from repro_torch.core import distance_matrix
from repro_torch.core.distance_matrix import (condensed_form,
                                              permuted_condensed,
                                              triangle_coords)
from repro_torch.core.mantel import MantelStatistic
from repro_torch.kernels import _build
from repro_torch.kernels.inverse_orders import (CLUSTER_SIZES, FILL_BLOCKS,
                                                MAX_N, SLICE_BYTES,
                                                cluster_size, inverse_orders,
                                                inverse_orders_plain)
from repro_torch.kernels.mantel_corr_ops import (mantel_corr_hoist,
                                                 mantel_corr_op)
from repro_torch.kernels.mantel_corr_ref import (mantel_corr_plain,
                                                 mantel_corr_rows)
from repro_torch.kernels.permute_reduce_ops import permute_reduce
from repro_torch.kernels.permute_reduce_ref import permute_reduce_rows
from repro_torch.stats.anosim import AnosimStatistic
from repro_torch.stats.partial_mantel import PartialMantelStatistic

REDUCE_TOL = {"rtol": 1e-5, "atol": 1e-5}
CORR_TOL = {"rtol": 1e-4, "atol": 1e-5}
SIZES = [2, 3, 17, 64, 97]
PERMS = 7


def _reference_orders(n, k=PERMS, seed=0):
    """The reference's own draw: argsort of threefry words."""
    return np.array(jax_orders(jax.random.PRNGKey(seed + n), k, n),
                    dtype=np.int32)


def _matrix(n, seed, dim=5):
    pts = np.random.default_rng(seed).normal(size=(n, dim))
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)).astype(np.float32)
    d = 0.5 * (d + d.T)
    np.fill_diagonal(d, 0.0)
    return d


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("n", SIZES)
def test_permute_reduce_rows_match_the_pallas_kernel(n, rows):
    rng = np.random.default_rng(10 * n + rows)
    m = n * (n - 1) // 2
    xc = rng.uniform(0.0, 4.0, size=m).astype(np.float32)
    ys = rng.normal(size=(rows, m)).astype(np.float32)
    orders = _reference_orders(n)
    got = permute_reduce_rows(torch.from_numpy(xc), torch.from_numpy(ys),
                              torch.from_numpy(orders))
    assert got.shape == (rows, PERMS) and got.dtype == torch.float32
    want = jax_reduce(jnp.asarray(xc), jnp.asarray(ys), jnp.asarray(orders),
                      impl="pallas", interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **REDUCE_TOL)
    oracle = jax_oracle(jnp.asarray(xc), jnp.asarray(ys), jnp.asarray(orders))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **REDUCE_TOL)


@pytest.mark.parametrize("n", SIZES)
def test_mantel_corr_rows_match_the_pallas_kernel(n):
    """The raw sums Σ_ij x[o_i, o_j]·ŷ[i, j] for an x and a ŷ that are
    neither symmetric nor hollow: the Pallas kernel over the gathered
    squares, one block of n."""
    rng = np.random.default_rng(n)
    x = rng.uniform(0.0, 4.0, size=(n, n)).astype(np.float32)
    yhat = rng.normal(size=(n, n)).astype(np.float32)
    orders = _reference_orders(n, seed=1)
    xp = np.stack([x[o][:, o] for o in orders])
    want = np.asarray(jax_mantel_kernel(jnp.asarray(xp), jnp.asarray(yhat),
                                        block_m=n, block_n=n, interpret=True))
    got = mantel_corr_rows(torch.from_numpy(x), torch.from_numpy(yhat),
                           torch.from_numpy(orders))
    assert got.shape == (PERMS,) and got.dtype == torch.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=CORR_TOL["rtol"],
                               atol=CORR_TOL["atol"] * max(scale, 1.0))


@pytest.mark.parametrize("n", SIZES[1:])
def test_mantel_corr_rows_give_the_references_pearson_r(n):
    """As ``mantel_corr_pallas`` returns them: the sums over 2‖x−x̄‖ (n = 2
    has one pair, so no Pearson r)."""
    x, y = _matrix(n, n), _matrix(n, n + 1)
    orders = _reference_orders(n, seed=2)
    want = np.asarray(mantel_corr_pallas(jnp.asarray(x), jnp.asarray(y),
                                         jnp.asarray(orders), perm_batch=PERMS,
                                         block=16, interpret=True))
    normxm, yhat = mantel_corr_hoist(torch.from_numpy(x), torch.from_numpy(y))
    got = mantel_corr_rows(torch.from_numpy(x), yhat,
                           torch.from_numpy(orders)) / (2.0 * normxm)
    np.testing.assert_allclose(got.numpy(), want, **CORR_TOL)


@pytest.mark.parametrize("n", SIZES)
def test_row_walks_equal_the_plain_versions(n):
    """The row-by-row walks and the plain versions the CPU path runs are
    one function: both sum in fp64 and round once."""
    rng = np.random.default_rng(n + 5)
    m = n * (n - 1) // 2
    xc = torch.from_numpy(rng.uniform(0.0, 4.0, size=m).astype(np.float32))
    ys = torch.from_numpy(rng.normal(size=(2, m)).astype(np.float32))
    orders = torch.from_numpy(_reference_orders(n, seed=3))
    np.testing.assert_allclose(permute_reduce_rows(xc, ys, orders).numpy(),
                               permute_reduce(xc, ys, orders).numpy(),
                               rtol=1e-6, atol=1e-6)
    x = torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))
    yhat = torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))
    np.testing.assert_allclose(mantel_corr_rows(x, yhat, orders).numpy(),
                               mantel_corr_plain(x, yhat, orders).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", SIZES)
def test_inverse_orders_plain_inverts_the_references_orders(n):
    orders = _reference_orders(n, seed=4)
    inv, orders16, is_perm = inverse_orders_plain(torch.from_numpy(orders))
    np.testing.assert_array_equal(inv.numpy(),
                                  np.argsort(orders, axis=1).astype(np.int32))
    np.testing.assert_array_equal(orders16.numpy().view(np.uint16), orders)
    np.testing.assert_array_equal(is_perm.numpy(), 1)
    got_inv, got16 = inverse_orders(torch.from_numpy(orders))
    assert torch.equal(got_inv, inv) and torch.equal(got16, orders16)


def test_inverse_orders_keep_sixteen_bits_up_to_their_limit():
    orders = np.stack([np.arange(MAX_N)[::-1],
                       np.roll(np.arange(MAX_N), 1)]).astype(np.int32)
    inv, orders16 = inverse_orders(torch.from_numpy(orders))
    np.testing.assert_array_equal(orders16.numpy().view(np.uint16), orders)
    np.testing.assert_array_equal(inv.numpy()[0], np.arange(MAX_N)[::-1])
    with pytest.raises(ValueError, match="16-bit"):
        inverse_orders(torch.zeros((1, MAX_N + 1), dtype=torch.int32))


@pytest.mark.parametrize("perms", [1, 2, 27, 32, 128])
@pytest.mark.parametrize("n", [1, 2, 7, 8, 1001, 16384, 46340, MAX_N])
def test_inverse_orders_cluster_plan(n, perms):
    """The card kernel's plan: C blocks a row from CLUSTER_SIZES, C <= n, a
    function of (B, n) alone; rank r owns the slots [ceil(r n / C),
    ceil((r + 1) n / C)), which cover 0..n-1 once, each within the shared
    memory budget; the smallest such C that lights FILL_BLOCKS blocks, or
    the largest that fits."""
    c = cluster_size(perms, n)
    assert c in CLUSTER_SIZES and c <= n
    assert cluster_size(perms, n) == c
    lo = np.array([-(-r * n // c) for r in range(c + 1)])
    assert lo[0] == 0 and lo[-1] == n
    sizes = np.diff(lo)
    assert (sizes >= 1).all() and 4 * sizes.max() <= SLICE_BYTES
    assert 4 * -(-n // c) <= SLICE_BYTES
    v = np.arange(n)
    owner = v * c // n                      # the kernel's owner of value v
    assert ((lo[owner] <= v) & (v < lo[owner + 1])).all()
    smaller = [s for s in CLUSTER_SIZES if s < c and s <= n
               and 4 * -(-n // s) <= SLICE_BYTES]
    if perms * c >= FILL_BLOCKS:
        assert all(perms * s < FILL_BLOCKS for s in smaller)
    else:
        assert c == min(8, max(s for s in CLUSTER_SIZES if s <= n))
    if (perms, n) == (32, 16384):
        assert c == 4                      # the main path's tile: 128 blocks
    if n == MAX_N:
        assert c >= 2


@pytest.mark.parametrize("fault", ["repeat", "negative", "too_large"])
def test_non_permutations_are_refused(fault):
    n = 17
    orders = _reference_orders(n, seed=5)
    bad = orders.copy()
    bad[3, 4] = {"repeat": bad[3, 9], "negative": -1, "too_large": n}[fault]
    flags = inverse_orders_plain(torch.from_numpy(bad))[2]
    np.testing.assert_array_equal(flags.numpy(),
                                  [1, 1, 1, 0, 1, 1, 1])
    message = "order row 3 is not a permutation"
    with pytest.raises(ValueError, match=message):
        inverse_orders(torch.from_numpy(bad))
    m = n * (n - 1) // 2
    xc, ys = torch.ones(m), torch.ones((1, m))
    with pytest.raises(ValueError, match=message):
        permute_reduce_rows(xc, ys, torch.from_numpy(bad))
    x = torch.from_numpy(_matrix(n, 6))
    with pytest.raises(ValueError, match=message):
        mantel_corr_rows(x, x, torch.from_numpy(bad))
    if fault == "repeat":         # in range: only the permutation check sees it
        with pytest.raises(ValueError, match=message):
            permute_reduce(xc, ys, torch.from_numpy(bad))
        with pytest.raises(ValueError, match=message):
            mantel_corr_op(x, x, torch.from_numpy(bad), perm_batch=PERMS)


@pytest.mark.parametrize("n,chunk", [(2, 5), (17, 7), (64, 1000), (97, 64)])
def test_permuted_condensed_is_the_permuted_squares_condensed_form(
        n, chunk, monkeypatch):
    d = torch.from_numpy(_matrix(n, n + 7))
    xc = condensed_form(d)
    order = torch.from_numpy(_reference_orders(n, k=1, seed=6)[0])
    monkeypatch.setattr(distance_matrix, "PERMUTED_CHUNK", chunk)
    got = permuted_condensed(xc, order, n)
    want = condensed_form(d[order.long()][:, order.long()])
    assert torch.equal(got, want)
    ii, jj = triangle_coords(n)
    m = n * (n - 1) // 2
    for start, stop in ((0, m), (m // 3, m), (1, max(m // 2, 1))):
        part = triangle_coords(n, start=start, stop=stop)
        assert torch.equal(part[0], ii[start:stop])
        assert torch.equal(part[1], jj[start:stop])


def test_hoists_keep_no_triangle_map_and_launch_nothing():
    """The card's kernels read no (ii, jj) map, so no hoist builds one;
    ANOSIM's hoist keeps the n group codes and no m-long within-group
    indicator: ``within_sums`` compares the permuted codes."""
    n = 40
    d, y, z = (torch.from_numpy(_matrix(n, s)) for s in (1, 2, 3))
    codes = torch.arange(n) % 3
    _build.reset_launches()
    hoists = [MantelStatistic(d, y, n).hoist(),
              PartialMantelStatistic(d, y, z, n).hoist(),
              AnosimStatistic(d, codes, n, 3).hoist()]
    assert set(_build.launches.values()) == {0}
    for inv in hoists:
        assert not {"ii", "jj"} & set(inv)
    assert torch.equal(hoists[2]["codes"].long(), codes)
    m = n * (n - 1) // 2
    assert [k for k, v in hoists[2].items()
            if torch.is_tensor(v) and v.numel() >= m] == ["ranks"]
