"""Per-kernel analytic cost model: traffic AND residency as closed forms.

The counterpart of ``repro/tune/model.py``. The traffic side is not a
re-derivation: every floats-moved figure comes from the ledger
(``repro_torch.obs.ledger``: the pass tables, ``perm_traffic_floats``,
``row_stationary_floats``, ``production_floats``), so the tuner's model
and the runtime's charges are the same functions. What this module adds
is the resident-set side: for each kernel, the working set that must stay
resident for the modeled traffic, as a closed form of the tile knobs, which
``tune.solve`` fits against a ``BackendBudget``.

Two families of terms:

* **the reference's** (``perm_batch_cost``, ``production_cost``,
  ``matvec_cost``): the Pallas tiles (``block``, ``feature_block``,
  ``chunk``) and the condensed gather, with the snapping rules of
  ``kernels.dispatch`` (``pick_block``, ``clamp_block``, ``snap_chunk``).
  On the CPU the port's plain versions run these tiles' arithmetic, and a
  solve under a reference budget gives the reference's tiles and floats.
* **the card's** (``perm_card_cost``, ``production_card_cost``,
  ``matvec_card_cost``), from the CUDA kernels' own geometry as their
  launch modules state it: ``permute_reduce`` moves 4m(S·B + L) + 8nB
  bytes a tile of B permutations in L = ⌈B/P⌉ launches of P
  permutations, and one block holds ``permute_reduce.shared_bytes``;
  ``center_matvec`` runs strips and a ring of stages of
  ``center_matvec.geometry``; ``pairwise_panel`` runs ``block``-row
  panels whose (b, d) rows and (b, n) output strip stay in L2 (the
  dense route only: the sparse route is not priced).

Parameter names match the ledger's: n observations, d features, B
permutation batch, S streamed invariant rows (Mantel 1, partial Mantel 2;
ANOSIM streams none through ``permute_reduce``: its tiles run
``within_sums``, whose shared memory is fixed), plus the tile knobs block /
feature_block / chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.kernels import center_matvec, permute_reduce
from repro_torch.kernels.dispatch import clamp_block, pick_block, snap_chunk
from repro_torch.obs.ledger import (FEATURE_HOIST_PASSES, HOIST_PASSES,
                                    ROW_STATIONARY_OUTPUTS, hoist_floats,
                                    perm_traffic_floats, production_floats,
                                    row_stationary_floats,
                                    row_stationary_launches)

__all__ = [
    "CostTerms", "condensed_size", "perm_batch_cost", "perm_batch_fit",
    "production_cost", "matvec_cost", "session_hoist_passes",
    "perm_card_cost", "production_card_cost", "matvec_card_cost",
    "SQUARE_SESSION_ARTIFACTS", "STANDALONE_SESSION_ARTIFACTS",
]

#: artifact builds of the canonical 4-analysis battery (pcoa + permanova
#: + permdisp + anosim) on ONE shared Workspace: the "11 passes" side of
#: the 11-vs-16 accounting
SQUARE_SESSION_ARTIFACTS = ("operator", "gram", "condensed", "ranks",
                            "coords")
#: the same battery as four one-shot Workspaces (the free functions): the
#: "16 passes" side
STANDALONE_SESSION_ARTIFACTS = ("operator", "coords",      # pcoa
                                "gram",                    # permanova
                                "operator", "coords",      # permdisp
                                "condensed", "ranks")      # anosim


def condensed_size(n: int) -> int:
    """m = n(n−1)/2."""
    return n * (n - 1) // 2


@dataclasses.dataclass(frozen=True)
class CostTerms:
    """One kernel configuration, costed.

    * ``traffic_floats``  — fp32 floats streamed end to end (the ledger
      figure; what the solver minimizes);
    * ``resident_floats`` — fp32 floats that must be live at once for the
      modeled traffic (what the solver fits under the budget);
    * ``base_floats``     — untunable always-resident state (the condensed
      source of the permutation loop), reported but not fitted;
    * ``params``          — the parameter point, for report audits.
    """

    op: str
    traffic_floats: float
    resident_floats: float
    base_floats: float
    params: dict

    @property
    def traffic_bytes(self) -> float:
        return 4.0 * self.traffic_floats

    @property
    def resident_bytes(self) -> float:
        return 4.0 * self.resident_floats

    def to_dict(self) -> dict:
        return {"op": self.op, "traffic_floats": self.traffic_floats,
                "traffic_bytes": self.traffic_bytes,
                "resident_floats": self.resident_floats,
                "resident_bytes": self.resident_bytes,
                "base_floats": self.base_floats,
                "params": dict(self.params)}


# --------------------------------------------------------------------------
# the reference's terms: the permutation inner loop (permute_reduce)
# --------------------------------------------------------------------------
def perm_resident_floats(n: int, batch: int, chunk: int, s: int = 1
                         ) -> float:
    """Tunable working set of one condensed scan step: the (B, chunk)
    gather tile, the (S, chunk) invariant tile, the two (chunk,)
    triangle-coordinate rows and the (B, n) order block."""
    return float(chunk) * (batch + s + 2) + float(batch) * n


def perm_batch_fit(n: int, chunk: int, budget_floats: float, s: int = 1
                   ) -> int:
    """Largest batch B whose scan-step working set fits ``budget_floats``
    at the given chunk: past it the invariant tiles no longer stay
    resident across the batch, so the modeled 3m/B amortization stops."""
    b = int((budget_floats - float(chunk) * (s + 2)) // (chunk + n))
    return max(b, 1)


def perm_batch_cost(n: int, batch: int, chunk: int, s: int = 1,
                    budget_floats: Optional[float] = None) -> CostTerms:
    """Per-permutation cost of the condensed fused loop at (B, chunk):
    the ledger's ``condensed_fused`` term m(1 + 3/B) + n, at the effective
    batch ``min(B, perm_batch_fit(...))`` when a budget is supplied."""
    m = condensed_size(n)
    chunk, _ = snap_chunk(m, chunk)
    b_eff = batch
    if budget_floats is not None:
        b_eff = min(batch, perm_batch_fit(n, chunk, budget_floats, s))
    per_perm = perm_traffic_floats(n, max(b_eff, 1))["condensed_fused"]
    return CostTerms(
        op="perm_batch", traffic_floats=per_perm,
        resident_floats=perm_resident_floats(n, batch, chunk, s),
        base_floats=float(m),
        params={"n": n, "batch": batch, "batch_effective": b_eff,
                "chunk": chunk, "s": s, "model": "condensed_fused"})


# --------------------------------------------------------------------------
# the reference's terms: the tiled distance production
# --------------------------------------------------------------------------
def production_cost(n: int, d: int, block: int,
                    feature_block: int = 128) -> CostTerms:
    """Feature traffic (the ledger's ``production_floats``) and a panel
    step's residency: the (b, d) row panel, one (b, feature_block)
    operand pair and the (b, n) output strip."""
    b = clamp_block(n, block)
    fb = max(min(feature_block, d), 1)
    resident = float(b) * d + 2.0 * b * fb + float(b) * n
    return CostTerms(
        op="production", traffic_floats=production_floats(n, d, block),
        resident_floats=resident, base_floats=0.0,
        params={"n": n, "d": d, "block": b, "feature_block": fb})


# --------------------------------------------------------------------------
# the reference's terms: the centred-operator matvec
# --------------------------------------------------------------------------
def matvec_cost(n: int, k: int, block: int, passes: float = 1.0,
                lane: int = 8) -> CostTerms:
    """``passes`` fused center-matvec sweeps, one read of D each (n²
    floats); a tile step holds one (b, b) D tile, the (b, k) x panel and
    the (b, k) partial output."""
    b = pick_block(n, block, lane)
    resident = float(b) * b + 2.0 * float(b) * max(k, 1)
    return CostTerms(
        op="matvec", traffic_floats=passes * hoist_floats("square", n),
        resident_floats=resident, base_floats=0.0,
        params={"n": n, "k": k, "block": b, "passes": passes})


# --------------------------------------------------------------------------
# the card's terms, from the CUDA kernels' own geometry
# --------------------------------------------------------------------------
def perm_card_cost(n: int, batch: int, s: int = 1) -> CostTerms:
    """Per-permutation cost of the card's row-stationary ``permute_reduce``
    on tiles of B: the ledger's ``row_stationary_floats``. A block holds
    the kernel's shared memory (a row of x, or the warps' fp64 partials
    of the launch's S·P outputs)."""
    per_launch, launches = row_stationary_launches(batch, s)
    resident_bytes = permute_reduce.shared_bytes(n, s, per_launch)
    return CostTerms(
        op="perm_batch", traffic_floats=row_stationary_floats(n, batch, s),
        resident_floats=resident_bytes / 4.0,
        base_floats=float(condensed_size(n)),
        params={"n": n, "batch": batch, "s": s,
                "perms_per_launch": per_launch,
                "launches_per_tile": launches,
                "max_outputs_per_launch": ROW_STATIONARY_OUTPUTS,
                "model": "row_stationary"})


def production_card_cost(n: int, d: int, block: int) -> CostTerms:
    """The card's production: ``pairwise_panel`` runs panels of
    ``clamp_block(n, block)`` rows, each reading its (b, d) rows and the
    whole table and writing a (b, n) strip; the rows and the strip stay
    in L2. Traffic is the ledger's ``production_floats``."""
    b = clamp_block(n, block)
    return CostTerms(
        op="production", traffic_floats=production_floats(n, d, block),
        resident_floats=float(b) * d + float(b) * n, base_floats=0.0,
        params={"n": n, "d": d, "block": b, "model": "pairwise_panel"})


def matvec_card_cost(n: int, k: int, passes: float = 1.0) -> CostTerms:
    """``passes`` ``center_matvec`` sweeps on the card: one read of D a
    launch, ``launches`` a sweep; a block owns a strip of output rows and
    keeps the ring's stages of a (strip rows x stage columns) D tile and
    its (stage columns x k) X rows. No knob of ``ExecConfig`` changes
    this geometry."""
    g = center_matvec.geometry(n, n, k)
    resident = float(g["stages"] * g["stage_cols"]
                     * (g["strip_rows"] + g["width"]))
    return CostTerms(
        op="matvec",
        traffic_floats=passes * g["launches"] * hoist_floats("square", n),
        resident_floats=resident, base_floats=0.0,
        params={"n": n, "k": k, "strip_rows": g["strip_rows"],
                "launches": g["launches"], "passes": passes,
                "model": "center_matvec"})


# --------------------------------------------------------------------------
# session-level pass accounting (the 11-vs-16 battery)
# --------------------------------------------------------------------------
def session_hoist_passes(artifacts, feature_backed: bool = False) -> float:
    """Total n²-passes of a session that builds ``artifacts`` (in order,
    duplicates = rebuilds), from the ledger's pass tables."""
    t = FEATURE_HOIST_PASSES if feature_backed else HOIST_PASSES
    return float(sum(t.get(a, 0.0) for a in artifacts))
