"""Shared permutation-test engine: paper §4.2's recipe, generalized.

The counterpart of ``repro/stats/engine.py``. A statistic splits at the
paper's hoisting boundary: ``hoist() -> invariants`` runs once,
``per_perm(invariants, order) -> scalar`` is the only work that scales with
K, and the optional ``per_batch(invariants, orders) -> (B,)`` is the
primary path. ``permutation_test`` pads the (K, n) orders up to full
``batch_size`` tiles by wrapping real permutations (``engine.py:226-246``
of the reference), hands each tile to ``per_batch`` — for the Mantel
family one launch of the ``permute_reduce`` kernel per tile on the card,
for ANOSIM one of ``within_sums`` —
and drops the padded tail before finishing. A test that draws its own
orders draws them a tile ahead (``OrderStream``): tile t + 1's words are
drawn on the host while the card runs tile t, the same bits as the whole
draw. Under an observing session (``repro_torch.obs``) the test, its
order draw included, runs in an ``engine.<method>`` span, the first
tile's draw in an ``engine.orders`` span, each tile in an ``engine.tile``
span and each later draw in an ``engine.orders_ahead`` span inside the
tile before it (a recording profiler sees them all without a session),
and,
for a statistic that names its ``ledger_model`` (the condensed gathers of
the Mantel family and ANOSIM, the statistics the reference batches),
charges a per-permutation model for every row of the padded tiles: that
model on the CPU, on the card the model of the kernel it runs (the
row-stationary ``permute_reduce``, ANOSIM's ``within_sums``);
each loop function notes its calls under the reference's sentinel
names (``stats.engine.*``).

Orders are the argsort of uint32-range random words from a CPU
``torch.Generator`` (the reference draws threefry bits in JAX, which torch
cannot reproduce): a seed gives the same orders on every device, but not
the reference's. The parity tests pass the reference's orders in through
``orders=``.

``permutation_test_distributed`` spreads the permutations over the perm
axes of a device mesh: the invariants are hoisted once on every rank,
each rank runs the padded tile loop over its K / P orders, and the null
is gathered in row-major rank order. Rank ``dev`` draws its orders from
the generator seeded by ``rank_seed(key, dev)`` (where the reference
folds the device index into its key), so the global null does not depend
on the mesh's shape beyond its perm-device count; ``rank_orders`` gives
the global orders the ranks draw.
"""

from __future__ import annotations

import contextvars
import dataclasses
import functools
from typing import Any, Optional, Protocol, Union, runtime_checkable

import numpy as np
import torch

from repro_torch.api.config import ExecConfig
from repro_torch.core.distance_matrix import as_generator
from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.launch.mesh import all_gather_tiled, axis_index, axis_size
from repro_torch.obs.compile import note_trace
from repro_torch.obs.trace import current_obs

ALTERNATIVES = ("two-sided", "greater", "less")
#: permutations per tile of the battery's tests (``Workspace``'s default
#: batch in the reference).
WORKSPACE_BATCH = 32


@runtime_checkable
class Statistic(Protocol):
    """A permutation-test statistic, split at the hoisting boundary. The
    observed statistic is ``per_perm(invariants, identity)``."""

    n: int

    def hoist(self) -> Any: ...

    def per_perm(self, invariants: Any, order: torch.Tensor) -> torch.Tensor: ...


@dataclasses.dataclass(frozen=True)
class PermutationTestResult:
    """What every permutation test returns; ``key`` is the int seed that
    drew the permutations (``None`` for given orders or a generator)."""

    statistic: float
    p_value: float
    sample_size: int
    permutations: int
    method: str = ""
    key: Optional[int] = dataclasses.field(default=None, compare=False)


def fixed_products(fn, orders: torch.Tensor) -> torch.Tensor:
    """``fn(orders)`` for a tile's (B, n) orders, computed on the card in
    products of exactly ``WORKSPACE_BATCH`` rows (a short last one padded
    by repeating its rows, the padding cut off). The batched statistics
    that run library products (PERMANOVA's ``G @ Z``, PERMDISP's batched
    centroids) would otherwise give a row other bits in a tile of
    another B: cuBLAS picks its algorithm by a product's shape. With the
    shape fixed, a row's statistic depends on that row alone, so tiles of
    any B, coalesced or not, agree bitwise. On the CPU, ``fn(orders)``."""
    rows = orders.shape[0]
    if orders.device.type != "cuda" or rows == WORKSPACE_BATCH:
        return fn(orders)
    pad = -rows % WORKSPACE_BATCH
    if pad:
        orders = torch.cat([orders, orders[torch.arange(
            pad, device=orders.device) % rows]])
    return torch.cat([fn(orders[b:b + WORKSPACE_BATCH])
                      for b in range(0, orders.shape[0],
                                     WORKSPACE_BATCH)])[:rows]


def permutation_orders(generator: Union[int, torch.Generator, None],
                       permutations: int, n: int,
                       device: DeviceLike = "cpu") -> torch.Tensor:
    """(K, n) int32 independent uniform permutations of range(n): the
    stable argsort of iid uint32-range words drawn on the CPU, in an
    ``engine.orders`` span (the draw, its copy, the argsort)."""
    with current_obs().span("engine.orders", permutations=permutations,
                            n=n):
        words = torch.randint(0, 2**32, (permutations, n),
                              dtype=torch.int64,
                              generator=as_generator(generator))
        return torch.argsort(words.to(device), dim=-1,
                             stable=True).to(torch.int32)


class OrderStream:
    """The orders of ``permutation_orders(generator, K, n, device)`` drawn
    one padded tile of ``batch_size`` at a time: the same bits, and a
    generator left where the whole draw leaves it.

    ``first()`` draws tile 0 in an ``engine.orders`` span. ``ahead(t)``
    draws tile t's rows in an ``engine.orders_ahead`` span; called after
    tile t − 1's launches, its copy and argsort queue behind them on the
    card while the host draws. ``tile(t)`` is padded tile t: the last one
    is filled with rows of tile 0, as ``null_distribution`` wraps them, so
    tile 0's orders are kept to the end. On the card the words pass
    through two pinned host buffers used in turn, each written again only
    once the event recorded behind its last copy has completed."""

    def __init__(self, generator: Union[int, torch.Generator, None],
                 permutations: int, n: int, batch_size: int,
                 device: torch.device):
        self.generator = as_generator(generator)
        self.permutations, self.n = permutations, n
        self.batch_size, self.device = batch_size, device
        self.tiles = -(-permutations // batch_size)
        self.drawn_ahead = 0
        self._pinned = device.type == "cuda"
        self._words: list = []
        self._copied: list = []
        self._first = self._next = None

    def _draw(self, t: int) -> torch.Tensor:
        """Tile t's real rows as (rows, n) int32 orders on the device."""
        rows = min(self.batch_size, self.permutations - t * self.batch_size)
        slot = t % len(self._words)
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()
        words = torch.randint(0, 2**32, (rows, self.n), dtype=torch.int64,
                              generator=self.generator,
                              out=self._words[slot][:rows])
        words = words.to(self.device, non_blocking=self._pinned)
        if self._pinned:
            self._copied[slot] = torch.cuda.Event()
            self._copied[slot].record(torch.cuda.current_stream(self.device))
        return torch.argsort(words, dim=-1, stable=True).to(torch.int32)

    def first(self) -> None:
        with current_obs().span("engine.orders",
                                permutations=self.permutations, n=self.n):
            if self.tiles:
                self._words = [torch.empty(
                    (min(self.batch_size, self.permutations), self.n),
                    dtype=torch.int64, pin_memory=self._pinned)
                    for _ in range(2 if self._pinned else 1)]
                self._copied = [None] * len(self._words)
                self._first = self._draw(0)

    def ahead(self, t: int) -> None:
        with current_obs().span("engine.orders_ahead",
                                rows=min(self.batch_size, self.permutations
                                         - t * self.batch_size), tile=t):
            self._next = self._draw(t)
        self.drawn_ahead += 1

    def tile(self, t: int) -> torch.Tensor:
        orders = self._first if t == 0 else self._next
        pad = self.tiles * self.batch_size - self.permutations
        if t == self.tiles - 1 and pad:
            wrap = torch.arange(pad, device=self.device) % self._first.shape[0]
            orders = torch.cat([orders, self._first[wrap]])
        return orders


def rank_seed(key: Union[int, None], dev: int) -> int:
    """The seed of perm device ``dev``'s generator: 64 bits of
    ``np.random.SeedSequence([key, dev])`` (``None``: key 0). The
    reference's ``fold_in(key, dev)`` has no torch counterpart; this is its
    documented stand-in. A ``torch.Generator`` is refused: its state
    cannot be split over ranks."""
    if isinstance(key, torch.Generator):
        raise TypeError("a torch.Generator key cannot be split over the "
                        "ranks of a mesh: pass an int seed")
    key = 0 if key is None else int(key)
    return int(np.random.SeedSequence([key, dev]).generate_state(
        1, dtype=np.uint64)[0])


def perm_share(mesh, perm_axes, permutations: int) -> tuple[int, int]:
    """``(per_dev, dev)``: the permutations each perm device runs and this
    rank's row-major index over ``perm_axes``. K must divide over them."""
    devices = axis_size(mesh, perm_axes)
    if permutations % devices:
        raise ValueError(f"permutations ({permutations}) must divide over "
                         f"{devices} devices")
    return permutations // devices, axis_index(mesh, perm_axes)


def rank_orders(key: Union[int, None], mesh, perm_axes, permutations: int,
                n: int, device: DeviceLike = "cpu") -> torch.Tensor:
    """(K, n) int32: the global orders the perm devices of ``mesh`` draw,
    device ``dev``'s K / P rows at ``dev · K / P``."""
    per_dev, _ = perm_share(mesh, perm_axes, permutations)
    return torch.cat([
        permutation_orders(rank_seed(key, dev), per_dev, n, device)
        for dev in range(permutations // per_dev)]) if per_dev else \
        torch.zeros((0, n), dtype=torch.int32, device=device)


def local_orders(key, mesh, perm_axes, permutations: int, n: int,
                 device: torch.device,
                 orders: Optional[torch.Tensor] = None) -> torch.Tensor:
    """This rank's (K / P, n) orders: its own draw, or its rows of the
    given global (K, n) ``orders``."""
    per_dev, dev = perm_share(mesh, perm_axes, permutations)
    if orders is None:
        return permutation_orders(rank_seed(key, dev), per_dev, n, device)
    orders = given_orders(orders, permutations, n, device)
    return orders[dev * per_dev:(dev + 1) * per_dev]


def given_orders(orders, permutations: int, n: int,
                 device: torch.device) -> torch.Tensor:
    """Caller-given (K, n) orders as int32 on ``device``, refused unless
    their shape is (K, n) and their indices lie in [0, n); the copy and
    the check run in an ``engine.orders`` span."""
    with current_obs().span("engine.orders", permutations=permutations,
                            n=n, given=True):
        orders = torch.as_tensor(orders).to(device=device,
                                            dtype=torch.int32)
        if tuple(orders.shape) != (permutations, n):
            raise ValueError(f"orders must be ({permutations}, {n}), got "
                             f"{tuple(orders.shape)}")
        if permutations and (int(orders.min()) < 0
                             or int(orders.max()) >= n):
            raise ValueError(f"orders must hold indices in [0, {n})")
        return orders


def count_better(orig_stat: torch.Tensor, permuted_stats: torch.Tensor,
                 alternative: str) -> int:
    """How many null draws are at least as extreme as the observed value."""
    if alternative == "two-sided":
        return int(torch.sum(permuted_stats.abs() >= orig_stat.abs()))
    if alternative == "greater":
        return int(torch.sum(permuted_stats >= orig_stat))
    if alternative == "less":
        return int(torch.sum(permuted_stats <= orig_stat))
    raise ValueError(f"unknown alternative {alternative!r}")


def finish(orig_stat: torch.Tensor, permuted_stats: torch.Tensor,
           permutations: int, alternative: str, n: int, method: str = "",
           key: Optional[int] = None) -> PermutationTestResult:
    """Monte-Carlo p-value with the +1 correction, divided in fp32 as the
    reference divides. A NaN observed statistic gives a NaN p-value."""
    c = count_better(orig_stat, permuted_stats, alternative)
    p_value = np.float32(c + 1) / np.float32(permutations + 1)
    stat = float(orig_stat)
    return PermutationTestResult(
        stat, float("nan") if np.isnan(stat) else float(p_value), n,
        permutations, method, key)


def charge_tiles(obs, op: str, stat: Statistic, device: torch.device,
                 rows: int, batch_size: int) -> None:
    """Charge ``rows`` permutations run in tiles of ``batch_size`` to the
    observing session: on the card the model of the kernel the statistic
    runs (``card_ledger_model``; unnamed, the row-stationary
    ``permute_reduce`` with the statistic's S invariant rows,
    ``ledger_rows``, 1 when unnamed), on the CPU the statistic's reference
    model (``ledger_model``, the condensed gather when unnamed)."""
    if device.type == "cuda":
        model = getattr(stat, "card_ledger_model", "row_stationary")
        params = {"s": getattr(stat, "ledger_rows", 1)} \
            if model == "row_stationary" else {}
        obs.charge_perm_batch(op, stat.n, rows, batch_size, model=model,
                              **params)
    else:
        obs.charge_perm_batch(op, stat.n, rows, batch_size,
                              model=getattr(stat, "ledger_model",
                                            "condensed_fused"))


def hoist_and_observe(stat: Statistic, device: torch.device):
    """``(invariants, observed)``: the hoist, and the statistic at the
    identity order."""
    note_trace("stats.engine.hoist_and_observe",
               (type(stat).__name__, stat.n))
    inv = stat.hoist()
    identity = torch.arange(stat.n, dtype=torch.int32, device=device)
    return inv, stat.per_perm(inv, identity)


#: the next tile's draw, which ``tile_statistics`` runs at the end of its
#: span; ``tile_loop`` sets it around each call (not an argument: callers
#: of ``tile_statistics``, and stand-ins for it, keep its three arguments)
_draw_next: contextvars.ContextVar = contextvars.ContextVar("draw_next",
                                                            default=None)


def tile_statistics(stat: Statistic, invariants, orders: torch.Tensor
                    ) -> torch.Tensor:
    """(B,) null statistics for one tile of permutation orders, in an
    ``engine.tile`` span; inside ``tile_loop`` the next tile's draw, if
    any, runs at the end of the span, after the tile's launches."""
    note_trace("stats.engine.tile",
               (type(stat).__name__, stat.n, orders.shape[0]))
    with current_obs().span("engine.tile", rows=orders.shape[0]):
        per_batch = getattr(stat, "per_batch", None)
        if per_batch is not None:
            out = per_batch(invariants, orders)
        else:
            out = torch.stack([stat.per_perm(invariants, o) for o in orders])
        draw = _draw_next.get()
        if draw is not None:
            _draw_next.set(None)
            draw()
        return out


def tile_loop(stat: Statistic, invariants, permutations: int,
              batch_size: int, device: torch.device, tile, ahead=None
              ) -> torch.Tensor:
    """(K,) null draws: one ``tile_statistics`` call per padded tile
    ``tile(t)`` of ``batch_size`` orders, the wrapped tail dropped;
    ``ahead(t + 1)``, when given, runs inside tile t's span (after it,
    should a replaced ``tile_statistics`` not run it)."""
    note_trace("stats.engine.null_distribution",
               (type(stat).__name__, stat.n, permutations, batch_size))
    if permutations == 0:
        return torch.zeros((0,), dtype=torch.float32, device=device)
    if getattr(stat, "per_batch", None) is not None:
        # K is not in this signature: one padded per_batch program per
        # (statistic, n, B) serves every K
        note_trace("stats.engine.per_batch",
                   (type(stat).__name__, stat.n, batch_size))
    num_tiles = -(-permutations // batch_size)
    tiles = []
    for t in range(num_tiles):
        token = _draw_next.set(functools.partial(ahead, t + 1)
                               if ahead is not None and t + 1 < num_tiles
                               else None)
        try:
            tiles.append(tile_statistics(stat, invariants, tile(t)))
        finally:
            pending = _draw_next.get()
            _draw_next.reset(token)
        if pending is not None:
            pending()
    return torch.cat(tiles)[:permutations]


def null_distribution(stat: Statistic, invariants, orders: torch.Tensor,
                      batch_size: int) -> torch.Tensor:
    """(K,) null draws of given (K, n) orders, padded to full tiles of
    ``batch_size`` by wrapping real permutations (``tile_loop``)."""
    permutations = orders.shape[0]
    total = -(-permutations // batch_size) * batch_size
    if total != permutations:
        wrap = torch.arange(total, device=orders.device) % permutations
        orders = orders[wrap]
    return tile_loop(stat, invariants, permutations, batch_size,
                     orders.device,
                     lambda t: orders[t * batch_size:(t + 1) * batch_size])

def encode_grouping(grouping) -> tuple[np.ndarray, int]:
    """Map arbitrary hashable labels to int codes in [0, num_groups), in
    the sorted order of the labels (numpy ``unique``)."""
    codes = np.unique(np.asarray(grouping), return_inverse=True)[1]
    num_groups = int(codes.max()) + 1
    if num_groups < 2:
        raise ValueError("grouping must contain at least two groups")
    if num_groups == codes.size:
        raise ValueError("grouping must have at least one group of size > 1")
    return codes.astype(np.int32), num_groups


def grouping_codes(grouping, n: int, device: torch.device
                   ) -> tuple[torch.Tensor, int]:
    """``encode_grouping`` on ``device``, refusing a grouping whose length
    is not ``n`` (``Workspace._codes`` of the reference)."""
    codes, num_groups = encode_grouping(grouping)
    if codes.size != n:
        raise ValueError("grouping length does not match distance matrix")
    return torch.from_numpy(codes).to(device), num_groups


def _batch_size(stat: Statistic, batch_size: Optional[int],
                config: Optional[ExecConfig], device: torch.device) -> int:
    """Explicit arg > ``config.batch_size`` > 8; a still-unresolved
    ``"auto"`` is solved against the statistic's n on ``device``."""
    batch_size = (config or ExecConfig()).resolve_batch_size(batch_size, 8)
    if batch_size == "auto":
        from repro_torch.tune.solve import solve_tiles
        batch_size = solve_tiles(stat.n, device=device).batch_size
    if batch_size < 1:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    return batch_size


def permutation_test(stat: Statistic, permutations: int = 999,
                     key: Union[int, torch.Generator, None] = None,
                     alternative: str = "two-sided",
                     batch_size: Optional[int] = None,
                     orders: Optional[torch.Tensor] = None, method: str = "",
                     device: DeviceLike = None,
                     config: Optional[ExecConfig] = None
                     ) -> PermutationTestResult:
    """Run a hoisted + fused Monte-Carlo permutation test of ``stat``,
    whose tensors lie on ``device`` (``None``: the card).

    ``key`` seeds the orders (an int, ``None`` for seed 0, or a CPU
    generator), drawn a tile ahead (``OrderStream``), the bits of
    ``permutation_orders``; ``orders`` replaces the draw with given (K, n)
    orders. The ``engine.<method>`` span's ``draws_ahead`` counts the
    tiles drawn inside an earlier tile's span.
    ``batch_size`` resolves as explicit arg > ``config.batch_size`` > 8; a
    still-unresolved ``"auto"`` (a config that never went through
    ``ExecConfig.resolve``) is solved here against the statistic's n on
    ``device``'s budget, never against K.
    """
    if alternative not in ALTERNATIVES:
        raise ValueError(f"unknown alternative {alternative!r}")
    dev = resolve_device(device)
    batch_size = _batch_size(stat, batch_size, config, dev)
    n = stat.n
    obs = current_obs()          # the ambient session (NULL_OBS when none)
    batched = getattr(stat, "per_batch", None) is not None
    tiles = -(-permutations // batch_size) if permutations else 0
    with obs.span(f"engine.{method or type(stat).__name__}",
                  phase="per_perm", n=n, permutations=permutations,
                  batch_size=batch_size, tiles=tiles,
                  batched=batched) as span:
        if orders is None:
            seed = 0 if key is None else \
                (None if isinstance(key, torch.Generator) else int(key))
            stream = OrderStream(key, permutations, n, batch_size, dev)
            stream.first()
            invariants, observed = hoist_and_observe(stat, dev)
            permuted = tile_loop(stat, invariants, permutations, batch_size,
                                 dev, stream.tile, stream.ahead)
            span.add(draws_ahead=stream.drawn_ahead)
        else:
            seed = None
            orders = given_orders(orders, permutations, n, dev)
            invariants, observed = hoist_and_observe(stat, dev)
            permuted = null_distribution(stat, invariants, orders, batch_size)
            span.add(draws_ahead=0)
    if getattr(stat, "ledger_model", None) is not None and permutations:
        # the padded tail rows are real gathers, so they are charged too
        charge_tiles(obs, method or type(stat).__name__, stat, dev,
                     tiles * batch_size, batch_size)
    return finish(observed, permuted, permutations, alternative, n,
                  method=method, key=seed)


def null_distribution_distributed(stat: Statistic, invariants, mesh,
                                  permutations: int, key=None,
                                  perm_axes=("data",), batch_size: int = 8,
                                  orders: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """(K,) null draws over the perm devices of ``mesh``: each rank's
    padded tile loop over its K / P orders, gathered in row-major rank
    order. Given the same global orders, a row's draw is the one
    ``null_distribution`` gives it (every tile is padded to
    ``batch_size`` either way)."""
    device = torch.device(mesh.device_type)
    mine = local_orders(key, mesh, perm_axes, permutations, stat.n, device,
                        orders)
    return all_gather_tiled(
        null_distribution(stat, invariants, mine, batch_size), mesh,
        perm_axes)


def permutation_test_distributed(stat: Statistic, mesh,
                                 permutations: int = 1024,
                                 key: Union[int, None] = None,
                                 alternative: str = "two-sided",
                                 perm_axes=("data",),
                                 batch_size: Optional[int] = None,
                                 config: Optional[ExecConfig] = None,
                                 method: str = "",
                                 orders: Optional[torch.Tensor] = None
                                 ) -> PermutationTestResult:
    """Permutation-parallel engine: K / P permutations on each of the P
    devices of ``perm_axes`` (row-major over several), whose tensors lie on
    the mesh's device type.

    The invariants are hoisted once on every rank; rank ``dev`` draws its
    orders from ``rank_seed(key, dev)`` (an int key or ``None``; a
    generator is refused), or takes its rows of the given global (K, n)
    ``orders``; the null is gathered in rank order and finished on every
    rank. ``batch_size`` resolves as in ``permutation_test``.
    """
    if alternative not in ALTERNATIVES:
        raise ValueError(f"unknown alternative {alternative!r}")
    device = torch.device(mesh.device_type)
    batch_size = _batch_size(stat, batch_size, config, device)
    invariants, observed = hoist_and_observe(stat, device)
    permuted = null_distribution_distributed(
        stat, invariants, mesh, permutations, key, perm_axes, batch_size,
        orders)
    seed = None if orders is not None else (0 if key is None else int(key))
    return finish(observed, permuted, permutations, alternative, stat.n,
                  method=method, key=seed)
