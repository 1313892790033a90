"""ANOSIM's within-group rank sums (``kernels.within_sums``).

On the CPU the plain version is held against a brute-force double loop
over the pairs, and the card kernel's tile walk (``within_sums_tiles``)
against the plain version: every sum is an exact integer of doubled ranks
halved once, so both are held bit for bit. The card tests skip without a
card (the ``cuda`` fixture); there the kernel is held bit for bit against
the plain version, two launches against each other, and one permutation's
sum against itself beside other tile-mates. This file imports no JAX, so
on the card it runs without the suite's conftest:
``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_within_sums.py``.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro_torch.core.mantel import MantelStatistic
from repro_torch.kernels import _build
from repro_torch.kernels.within_sums import (MAX_PERMS, TILE, partials_cost,
                                             tile_cost, tile_count)
from repro_torch.kernels.within_sums_ops import within_sums
from repro_torch.kernels.within_sums_ref import (within_sums_finish_ref,
                                                 within_sums_ref,
                                                 within_sums_tiles)
from repro_torch.obs.ledger import Ledger, within_sums_floats
from repro_torch.stats import engine
from repro_torch.stats.anosim import AnosimStatistic, _rank_average


@pytest.fixture
def cuda():
    """The card; decided when a test runs, never at import, so every
    worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(n, groups, perms, seed, ties=False, device="cpu"):
    """(ranks, codes, orders): the fp32 average ranks of m random values
    (rounded to a few levels when ``ties``), codes in [0, groups), and
    ``perms`` random permutations."""
    rng = np.random.default_rng(seed)
    m = n * (n - 1) // 2
    values = torch.from_numpy(rng.normal(size=m).astype(np.float32))
    if ties:
        values = torch.round(values)
    ranks = _rank_average(values.to(device))
    codes = torch.from_numpy(rng.integers(0, groups, size=n))
    orders = torch.from_numpy(np.stack([rng.permutation(n)
                                        for _ in range(perms)]))
    return ranks, codes.to(device), orders.to(device)


def _brute(ranks, codes, orders):
    """The sums by a double loop over the pairs, in fp64."""
    n = codes.numel()
    r, c, o = ranks.tolist(), codes.tolist(), orders.tolist()
    out = []
    for row in o:
        total, k = 0.0, 0
        for i in range(n):
            for j in range(i + 1, n):
                if c[row[i]] == c[row[j]]:
                    total += r[k]
                k += 1
        out.append(total)
    return torch.tensor(out, dtype=torch.float32)


@pytest.mark.parametrize("n,groups,perms,ties", [
    (2, 2, 4, False), (7, 3, 5, False), (24, 4, 8, False),
    (33, 3, 6, True), (40, 5, 3, True)])
def test_plain_matches_the_double_loop(n, groups, perms, ties):
    ranks, codes, orders = _case(n, groups, perms, seed=n, ties=ties)
    want = _brute(ranks, codes, orders)
    assert torch.equal(within_sums(ranks, codes, orders), want)
    assert torch.equal(within_sums_ref(ranks, codes, orders, 5), want)


def test_one_group_sums_every_pair_and_n_groups_none():
    n = 30
    ranks, _, orders = _case(n, 1, 5, seed=3)
    one = torch.zeros(n, dtype=torch.int64)
    total = torch.sum(ranks.double()).float()
    assert torch.equal(within_sums(ranks, one, orders),
                       total.expand(5))
    assert torch.equal(within_sums(ranks, one, orders),
                       _brute(ranks, one, orders))
    distinct = torch.arange(n)
    assert torch.equal(within_sums(ranks, distinct, orders),
                       torch.zeros(5))


def test_codes_past_a_byte():
    """300 groups: codes a byte cannot hold, compared whole."""
    n = 40
    ranks, _, orders = _case(n, 2, 4, seed=4)
    codes = torch.from_numpy(np.random.default_rng(4).integers(
        0, 300, size=n))
    codes[:6] = torch.tensor([0, 256, 256, 299, 43, 299])
    want = _brute(ranks, codes, orders)
    assert want.abs().sum() > 0
    assert torch.equal(within_sums(ranks, codes, orders), want)
    # a code and that code plus 256 are different groups
    wrapped = codes.clone()
    wrapped[1] = 0
    assert not torch.equal(within_sums(ranks, wrapped, orders), want)


@pytest.mark.parametrize("perms", [1, 5, 13, 31])
def test_batches_that_are_not_a_multiple_of_eight(perms):
    ranks, codes, orders = _case(21, 3, perms, seed=perms)
    got = within_sums(ranks, codes, orders)
    assert got.shape == (perms,)
    assert torch.equal(got, _brute(ranks, codes, orders))


def test_non_permutation_orders_are_refused():
    ranks, codes, orders = _case(12, 3, 4, seed=5)
    bad = orders.clone()
    bad[2, 3] = bad[2, 4]                        # a repeated index
    with pytest.raises(ValueError, match="order row 2 is not a permutation"):
        within_sums(ranks, codes, bad)
    out_of_range = orders.clone()
    out_of_range[0, 0] = 12
    with pytest.raises(ValueError, match="not a permutation"):
        within_sums(ranks, codes, out_of_range)


def test_shapes_and_sizes_are_checked():
    ranks, codes, orders = _case(10, 2, 3, seed=6)
    with pytest.raises(ValueError, match="condensed length"):
        within_sums(ranks[:-1], codes, orders)
    with pytest.raises(ValueError, match="integers"):
        within_sums(ranks, codes.float(), orders)
    with pytest.raises(TypeError):
        within_sums(ranks.double(), codes, orders)
    with pytest.raises(ValueError, match="supports n <="):
        within_sums(ranks, codes, torch.zeros((1, 46341), dtype=torch.int64))
    empty = within_sums(torch.zeros(0), torch.zeros(1, dtype=torch.int64),
                        torch.zeros((3, 1), dtype=torch.int64))
    assert torch.equal(empty, torch.zeros(3))


@pytest.mark.parametrize("n,tile", [(2, 4), (9, 4), (33, 8), (64, 16),
                                    (70, 32)])
def test_the_kernels_tile_walk_counts_every_pair_once(n, tile):
    ranks, codes, orders = _case(n, 3, 6, seed=n + tile, ties=True)
    assert torch.equal(within_sums_tiles(ranks, codes, orders, tile),
                       within_sums_ref(ranks, codes, orders, 1000))


def test_finish_halves_exact_sums_once():
    partials = torch.tensor([[3, 2**40 + 1], [4, 2**41]], dtype=torch.int64)
    got = within_sums_finish_ref(partials)
    want = torch.tensor([3.5, (3 * 2**40 + 1) / 2], dtype=torch.float64)
    assert torch.equal(got, want.float())


def test_stated_cost_is_the_tiles():
    """The launch module's cost: the ranks once, each tile's codes, a
    compare and an add a tile slot; the ledger charges it a permutation."""
    n, perms = 300, 32
    m = n * (n - 1) // 2
    nt = -(-n // TILE)
    assert tile_count(n) == nt * (nt + 1) // 2 == 6
    nbytes, ops = partials_cost(n, perms, 0)
    # tiles (0,0), (0,1), (0,2), (1,1), (1,2), (2,2) of 128, 128, 44
    slots = 128 * 128 * 3 + 128 * 44 * 2 + 44 * 44
    edges = 256 + 256 + 172 + 256 + 172 + 88        # rows + columns a tile
    assert ops == 2.0 * slots * perms
    assert nbytes == 4.0 * m + 6.0 * edges * perms
    assert within_sums_floats(n, perms) * 4 * perms == tile_cost(n, perms,
                                                                 0)[0]
    led = Ledger()
    e = led.charge_perm_batch("anosim", n, 64, perms, model="within_sums")
    assert e.floats == pytest.approx(64 * within_sums_floats(n, perms))


def test_anosim_tiles_on_the_card_charge_within_sums():
    """The engine charges ANOSIM's card tiles to within_sums and the
    Mantel family's to the row-stationary permute_reduce."""
    class Recorder:
        def __init__(self):
            self.calls = []

        def charge_perm_batch(self, op, n, rows, batch, **params):
            self.calls.append((op, params))

    obs, card = Recorder(), torch.device("cuda")
    n = 12
    codes = torch.arange(n) % 3
    d = torch.rand(n * (n - 1) // 2)
    engine.charge_tiles(obs, "anosim", AnosimStatistic(d, codes, n, 3),
                        card, 64, 32)
    engine.charge_tiles(obs, "mantel", MantelStatistic(d, d, n), card, 64,
                        32)
    assert obs.calls == [("anosim", {"model": "within_sums"}),
                         ("mantel", {"model": "row_stationary", "s": 1})]


def test_anosim_hoist_refuses_ranks_it_cannot_double_exactly():
    n = 12
    d = torch.rand(n * (n - 1) // 2, dtype=torch.float64)
    stat = AnosimStatistic(d, torch.arange(n) % 3, n, 3)
    with pytest.raises(ValueError, match="fp32 ranks"):
        stat.hoist()


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,perms", [(2, 32), (33, 32), (1000, 32),
                                     (4096, 32), (1000, 5), (300, 130)])
def test_kernel_matches_plain_bitwise(cuda, n, perms):
    ranks, codes, orders = _case(n, 4, perms, seed=n + perms, ties=n > 100,
                                 device=cuda)
    _build.reset_launches()
    got = within_sums(ranks, codes, orders)
    slabs = -(-perms // MAX_PERMS)
    assert _build.launches["within_sums"] == slabs
    assert _build.launches["within_sums_finish"] == slabs
    assert _build.launches["inverse_orders"] == 1
    assert _build.launches["permute_reduce"] == 0
    want = within_sums_ref(ranks, codes, orders, 65536)
    assert torch.equal(got, want)
    assert torch.equal(within_sums(ranks, codes, orders), got)


def test_kernel_where_doubled_ranks_pass_2_28(cuda):
    """n = 16385: 2·rank passes 2^28, past the benchmark's n = 16384; up
    to n = 46340 it stays below 2^31, so two terms still sum exactly in
    32 bits."""
    ranks, codes, orders = _case(16385, 4, 3, seed=7, device=cuda)
    assert float(ranks.max()) * 2 >= 2**28
    assert torch.equal(within_sums(ranks, codes, orders),
                       within_sums_ref(ranks, codes, orders, 2**22))


def test_kernel_sum_does_not_depend_on_its_tile_mates(cuda):
    n = 2000
    ranks, codes, orders = _case(n, 3, 32, seed=8, device=cuda)
    alone = within_sums(ranks, codes, orders[5:6])
    others = _case(n, 3, 32, seed=9, device=cuda)[2]
    for pos in (0, 17, 31):
        mixed = others.clone()
        mixed[pos] = orders[5]
        assert torch.equal(within_sums(ranks, codes, mixed)[pos], alone[0])


def test_kernel_refuses_non_permutations(cuda):
    ranks, codes, orders = _case(100, 3, 8, seed=10, device=cuda)
    bad = orders.clone()
    bad[6, 0] = bad[6, 1]
    with pytest.raises(ValueError, match="order row 6 is not a permutation"):
        within_sums(ranks, codes, bad)


def test_anosim_launches_within_sums_once_a_tile(cuda):
    from repro_torch.core.distance_matrix import DistanceMatrix
    from repro_torch.core import random_distance_matrix
    from repro_torch.stats import anosim
    dm = random_distance_matrix(3, 200, dim=5, device="cpu")
    groups = np.arange(200) % 4
    orders = engine.permutation_orders(5, 70, 200)
    cpu = anosim(dm, groups, 70, orders=orders, device="cpu")
    on_card = DistanceMatrix(dm.data, device=cuda)     # validated: symhollow
    _build.reset_launches()
    card = anosim(on_card, groups, 70, orders=orders, device=cuda)
    assert {k: v for k, v in _build.launches.items() if v} == {
        "inverse_orders": 3, "within_sums": 3, "within_sums_finish": 3}
    # the ranks' fp32 total sums in another order on the card: the
    # battery's card-against-CPU tolerance (tests/test_torch_cuda.py)
    assert abs(card.statistic - cpu.statistic) <= 1e-5
    assert card.p_value == cpu.p_value
