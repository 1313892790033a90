"""The tile solver: budget in, every knob out.

The counterpart of ``repro/tune/solve.py``: enumerate candidates through
the snapping rules the kernels execute, keep those whose modeled resident
set (``tune.model``) fits the ``BackendBudget``, and take the one that
minimizes modeled effective traffic.

Under a reference budget (the ``"cpu"``, ``"tpu"`` and ``"gpu"`` columns,
or a reference profile) the solver is the reference's, candidate for
candidate, with the CPU's snapping geometry (``dispatch.lane_geometry``:
8-row lanes, floor 1, the reference's interpreter geometry): it returns
the reference's tiles and modeled floats. Under the card's budget
(``backend="cuda"``) it solves the CUDA kernels' own geometry:

* ``batch_size`` is the largest candidate whose ``permute_reduce`` launch
  fits one block's shared memory with S·B <= 128 outputs a launch, so a
  tile is one launch; the row-stationary traffic per permutation,
  m·(S + L/B) + 2n, falls with B up to that point;
* ``block`` (the production's panel rows and the condensed operator's
  strips) is the largest candidate, capped at the default, whose panel
  rows and output strip fit L2;
* ``chunk`` and ``feature_block`` are Pallas tiles that no route of the
  card reads: they keep the defaults and the record lists them under
  ``unread``.

Guarantees the tests pin, on both: the default is always a candidate, so
the solved choice never models worse effective traffic than the
constants it replaces; ``batch_size`` and ``chunk`` are solved from
(n, S, budget) only, never from K, so one padded per-batch program serves
every K; ``feature_block`` and ``block`` only shrink (a block the default
run never executed would re-associate the operator's strip sums); n past
the int32 triangle bound is refused here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.distance_matrix import MAX_TRIANGLE_N
from repro_torch.kernels.dispatch import (clamp_block, lane_geometry,
                                          pick_block, snap_chunk)
from repro_torch.obs.ledger import ROW_STATIONARY_OUTPUTS
from repro_torch.tune.budget import (BackendBudget, detect_budget,
                                     load_profile)
from repro_torch.tune.model import (condensed_size, matvec_card_cost,
                                    matvec_cost, perm_batch_cost,
                                    perm_batch_fit, perm_card_cost,
                                    production_card_cost, production_cost)

__all__ = ["TunedTiles", "solve_tiles", "resolve_exec_config",
           "DEFAULT_BLOCK", "DEFAULT_FEATURE_BLOCK", "DEFAULT_BATCH",
           "DEFAULT_CHUNK", "BATCH_MAX"]

# the hand-picked constants the solver must never price worse than, one
# copy each, pinned against the modules that execute them in the tests
DEFAULT_BLOCK = 256          # production panels / condensed strips
DEFAULT_FEATURE_BLOCK = 128  # the reference's pairwise feature chunk
DEFAULT_BATCH = 32           # the Workspace battery's batch
DEFAULT_CHUNK = 65536        # permute_reduce's condensed chunk (plain)

#: solved batches cap here regardless of budget headroom
BATCH_MAX = 128

_BLOCK_CANDIDATES = (2048, 1024, 512, 256, 128, 64, 32, 16, 8)
_CHUNK_CANDIDATES = (131072, 65536, 32768, 16384, 8192, 4096)
_BATCH_CANDIDATES = (128, 64, 32, 16, 8)
_MIN_CHUNK = 4096
_MIN_FEATURE_BLOCK = 8
#: the knobs a card solve leaves to the defaults: no CUDA route reads them
CARD_UNREAD = ("chunk", "feature_block")


@dataclasses.dataclass(frozen=True)
class TunedTiles:
    """One solved configuration: the knobs, the budget they were fit
    against, and the modeled costs of both the solved and the default
    tiles. ``unread`` names the knobs no route of the budget's device
    reads."""

    n: int
    d: Optional[int]
    block: int
    feature_block: int
    batch_size: int
    chunk: int
    backend: str
    budget: BackendBudget
    modeled: dict
    modeled_default: dict
    unread: tuple = ()

    def to_dict(self) -> dict:
        return {"n": self.n, "d": self.d, "block": self.block,
                "feature_block": self.feature_block,
                "batch_size": self.batch_size, "chunk": self.chunk,
                "backend": self.backend, "budget": self.budget.to_dict(),
                "modeled": dict(self.modeled),
                "modeled_default": dict(self.modeled_default),
                "unread": list(self.unread)}


# --------------------------------------------------------------------------
# the reference's solve (the Pallas tiles, on a reference budget)
# --------------------------------------------------------------------------
def _fit_block(n: int, d: Optional[int], fb: int, lane: int, floor: int,
               budget_floats: float, cap: Optional[int] = None) -> int:
    """Largest lane-snapped candidate block (<= ``cap`` when given) whose
    production AND matvec resident sets fit; with ``cap`` also the
    effective block of a requested size under the budget, which is how
    ``modeled_default`` is priced."""
    d_eff = d if d is not None else 0     # square-backed: no production
    cands = set(_BLOCK_CANDIDATES + (DEFAULT_BLOCK,))
    if cap is not None:
        cands.add(cap)
    seen = []
    for cand in sorted(cands, reverse=True):
        if cap is not None and cand > cap:
            continue
        b = pick_block(n, cand, lane, floor=floor)
        if b in seen:
            continue
        seen.append(b)
        fits_mv = matvec_cost(n, 16, b, lane=lane).resident_floats \
            <= budget_floats
        fits_prod = (d_eff == 0
                     or production_cost(n, d_eff, b, fb).resident_floats
                     <= budget_floats)
        if fits_mv and fits_prod:
            return b
    return seen[-1] if seen else pick_block(n, floor, lane, floor=floor)


def _solve_batch_chunk(n: int, s: int, budget_floats: float
                       ) -> tuple[int, int]:
    """Joint (batch, chunk): the largest candidate batch for which some
    chunk >= _MIN_CHUNK keeps the scan step resident, with the largest
    such chunk."""
    m = condensed_size(n)
    for batch in _BATCH_CANDIDATES:
        for cand in _CHUNK_CANDIDATES:
            chunk, _ = snap_chunk(m, cand)
            cost = perm_batch_cost(n, batch, chunk, s)
            if (cost.resident_floats <= budget_floats
                    and chunk >= min(_MIN_CHUNK, m)):
                return batch, chunk
    chunk, _ = snap_chunk(m, _MIN_CHUNK)
    return perm_batch_fit(n, chunk, budget_floats, s), chunk


def _solve_reference(n: int, d: Optional[int], budget: BackendBudget,
                     s: int) -> TunedTiles:
    bf = budget.working_floats
    lane, floor = lane_geometry("cpu")

    # feature_block: start at the default (clamped to d) and SHRINK only
    # while even the smallest block cannot fit the production step
    fb = DEFAULT_FEATURE_BLOCK if d is None else max(
        min(DEFAULT_FEATURE_BLOCK, d), 1)
    if d:
        while (fb > _MIN_FEATURE_BLOCK
               and production_cost(n, d, pick_block(n, 8, lane, floor=floor),
                                   fb).resident_floats > bf):
            fb //= 2

    block = _fit_block(n, d, fb, lane, floor, bf, cap=DEFAULT_BLOCK)
    batch, chunk = _solve_batch_chunk(n, s, bf)
    batch = max(min(batch, BATCH_MAX), 1)

    def _modeled(blk, f_blk, bt, ck):
        # priced at the EFFECTIVE tiles under the budget, for the solved
        # and the hand-picked constants alike
        f_blk = max(min(f_blk, d), 1) if d else f_blk
        b_eff = _fit_block(n, d, f_blk, lane, floor, bf, cap=blk)
        out = {"perm_batch": perm_batch_cost(n, bt, ck, s,
                                             budget_floats=bf).to_dict(),
               "matvec": matvec_cost(n, 16, b_eff, lane=lane).to_dict()}
        if d:
            out["production"] = production_cost(n, d, b_eff,
                                                f_blk).to_dict()
        return out

    return TunedTiles(
        n=n, d=d, block=block, feature_block=fb, batch_size=batch,
        chunk=chunk, backend=budget.backend, budget=budget,
        modeled=_modeled(block, fb, batch, chunk),
        modeled_default=_modeled(DEFAULT_BLOCK, DEFAULT_FEATURE_BLOCK,
                                 DEFAULT_BATCH, DEFAULT_CHUNK))


# --------------------------------------------------------------------------
# the card's solve (the CUDA kernels' geometry, on the card's budget)
# --------------------------------------------------------------------------
def _fit_card_block(n: int, d: Optional[int], budget_floats: float,
                    cap: int) -> int:
    """Largest candidate panel (<= ``cap``) whose rows and output strip fit
    L2; square-backed sessions run no production and keep ``cap``."""
    if not d:
        return clamp_block(n, cap)
    cands = sorted({c for c in _BLOCK_CANDIDATES + (cap,) if c <= cap},
                   reverse=True)
    for cand in cands:
        if production_card_cost(n, d, cand).resident_floats \
                <= budget_floats:
            return clamp_block(n, cand)
    return clamp_block(n, cands[-1])


def _card_batch(n: int, s: int, shared_bytes: int) -> int:
    """The largest candidate batch that one launch takes (S·B <= 128) and
    whose block fits the shared memory a block may opt in to. When no
    batch fits (a row of x alone exceeds it), no batch choice can help,
    and the largest one a launch takes models the least traffic."""
    allowed = [b for b in _BATCH_CANDIDATES
               if s * b <= ROW_STATIONARY_OUTPUTS]
    for batch in allowed:
        if perm_card_cost(n, batch, s).resident_bytes <= shared_bytes:
            return batch
    return allowed[0] if allowed else _BATCH_CANDIDATES[-1]


def _solve_card(n: int, d: Optional[int], budget: BackendBudget,
                s: int) -> TunedTiles:
    if budget.shared_bytes is None:
        raise ValueError("a card budget needs shared_bytes (the shared "
                         "memory one block may opt in to)")
    bf = budget.working_floats
    block = _fit_card_block(n, d, bf, DEFAULT_BLOCK)
    batch = max(min(_card_batch(n, s, budget.shared_bytes), BATCH_MAX), 1)
    fb = DEFAULT_FEATURE_BLOCK if d is None else max(
        min(DEFAULT_FEATURE_BLOCK, d), 1)
    chunk, _ = snap_chunk(condensed_size(n), DEFAULT_CHUNK)

    def _modeled(blk, bt):
        out = {"perm_batch": perm_card_cost(n, bt, s).to_dict(),
               "matvec": matvec_card_cost(n, 16).to_dict()}
        if d:
            out["production"] = production_card_cost(
                n, d, _fit_card_block(n, d, bf, blk)).to_dict()
        return out

    return TunedTiles(
        n=n, d=d, block=block, feature_block=fb, batch_size=batch,
        chunk=chunk, backend=budget.backend, budget=budget,
        modeled=_modeled(block, batch),
        modeled_default=_modeled(DEFAULT_BLOCK, DEFAULT_BATCH),
        unread=CARD_UNREAD)


def solve_tiles(n: int, d: Optional[int] = None, *,
                budget: Optional[BackendBudget] = None,
                profile: Optional[str] = None,
                device: Union[str, torch.device, None] = None,
                s: int = 2) -> TunedTiles:
    """Solve every tile knob for ``n`` observations (and ``d`` features
    when feature-backed).

    ``s`` is the widest streamed-invariant stack the session may run
    (partial Mantel stacks 2 rows), so one solve serves the whole
    battery. K is deliberately not a parameter. The budget is ``budget``,
    else the ``profile`` JSON, else ``detect_budget(device)`` (``None``:
    the card).
    """
    if n > MAX_TRIANGLE_N:
        raise ValueError(
            f"solve_tiles supports n <= {MAX_TRIANGLE_N} (int32 triangle "
            f"indexing would overflow in the permutation kernels); got "
            f"n={n}")
    if n < 1:
        raise ValueError(f"need n >= 1, got n={n}")
    if budget is None:
        budget = load_profile(profile) if profile else detect_budget(device)
    if budget.backend == "cuda":
        return _solve_card(n, d, budget, s)
    return _solve_reference(n, d, budget, s)


def resolve_exec_config(config, n: int, d: Optional[int] = None):
    """Materialize an ``ExecConfig``'s auto knobs into concrete tiles.

    Returns ``(resolved_config, tuned)``: every ``"auto"`` knob (and under
    ``auto=True`` every knob left at its default) replaced by the solved
    value, or ``(config, None)`` when nothing asked for tuning. Knobs set
    to concrete values are honored, even under ``auto=True``. The budget
    is the config's ``tune_profile``, else its device's.
    """
    auto_all = bool(config.auto)

    def wants(name, default):
        v = getattr(config, name)
        return v == "auto" or (auto_all and v == default)

    want_block = wants("block", DEFAULT_BLOCK)
    want_fb = wants("feature_block", DEFAULT_FEATURE_BLOCK)
    want_batch = wants("batch_size", None)
    want_chunk = wants("chunk", None)
    if not (want_block or want_fb or want_batch or want_chunk):
        return config, None

    tuned = solve_tiles(n, d, profile=config.tune_profile,
                        device=config.device)
    updates = {"auto": False}
    if want_block:
        updates["block"] = tuned.block
    if want_fb:
        updates["feature_block"] = tuned.feature_block
    if want_batch:
        updates["batch_size"] = tuned.batch_size
    if want_chunk:
        updates["chunk"] = tuned.chunk
    return dataclasses.replace(config, **updates), tuned
