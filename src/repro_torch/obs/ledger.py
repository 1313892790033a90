"""Analytic traffic ledger: one audited cost-term registry, charged live.

The counterpart of ``repro/obs/ledger.py``, copied term for term: the
reference's committed ratios re-derive from this copy (10.97x and 16.45x
for the Mantel loop at n = 2048, B = 32; 11 against 16 n²-passes for a
four-analysis session; ``tests/test_torch_obs.py``). The instrumented
port (Workspace hoist builds, the engine's permutation batches, the
``repro_torch.dist`` production sweep) charges a per-session ``Ledger``
with the same terms, so a ``RunReport`` carries its own accounting.

Beside the reference's models stands the port's own: the row-stationary
``permute_reduce`` of the card moves other bytes than ``condensed_fused``
— 4m(S·B + L) + 8nB a tile of B permutations in L launches
(``row_stationary_floats``). The engine and the serve scheduler charge it
for tiles that run on the card, the reference's model on the CPU;
ANOSIM's tiles on the card run ``within_sums`` instead and charge its
launches' bytes (``within_sums_floats``).

Registry layout
---------------
* ``HOIST_PASSES`` — n²-sized fp32 passes per HoistCache artifact build
  on a **square-backed** session (reads + writes of n²-sized buffers).
* ``FEATURE_HOIST_PASSES`` — the same table for a **feature-backed**
  session (condensed production: the square never exists, so several
  builds get cheaper or free).
* ``perm_traffic_floats(n, batch)`` — audited fp32 floats moved PER
  PERMUTATION by each formulation of the Mantel-family inner loop.
* ``row_stationary_floats(n, batch, s)`` — the same per-permutation
  figure for the card's row-stationary ``permute_reduce``.
* ``within_sums_floats(n, batch)`` — the figure for ANOSIM's
  ``within_sums`` kernel on the card.
* ``production_floats(n, d, block)`` — feature reads of the tiled
  distance production sweep (identical for fused and materialized
  modes, which is why the pass tables exclude it).
* ``sparse_production_floats(n, d, block, nnz, rows)`` — the reads of
  the sparse-support production, which sums each Bray–Curtis pair over
  the nonzeros of a compressed copy of the table.

Costs are exact functions of (operation, n, d, K, B, block): every
``Ledger`` entry records the operation, the floats moved and the
parameters it was evaluated at, so a ``RunReport`` can be re-audited
offline.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.kernels.within_sums import tile_cost as within_sums_tile_cost

# --------------------------------------------------------------------------
# The audited registry
# --------------------------------------------------------------------------
#: Analytic n²-pass cost of building each HoistCache artifact on a
#: square-backed session (reads + writes of n²-sized fp32 buffers).
#: These mirror the implementations:
#:   operator    — row/global means of E = −½D∘D in ONE read of D (the
#:                 paper's hoist)
#:   gram        — fused centering: 2 reads + 2 writes (paper Alg. 2)
#:   condensed   — triangle extraction from the square: m-element gather
#:                 + m-element write ≈ 1 full pass (m = n(n−1)/2 ≈ ½n²)
#:   ranks       — O(m log m) sort of the cached condensed + condensed
#:                 rank write ≈ 1 pass (square-free since the
#:                 permute_reduce loop: no rank matrix is materialized)
#:   moments     — condensed read + centered-norm reduce ≈ ½ pass (O(m))
#:   coords      — the fsvd solve: 4 operator matvecs (range find +
#:                 2 power iterations + projection), each one read of D
#:   square      — the n² write of a materialized distance matrix
#:   dist_means  — rides the production sweep's running sums: free
HOIST_PASSES = {
    "operator": 1.0,
    "gram": 4.0,
    "condensed": 1.0,
    "ranks": 1.0,
    "moments": 0.5,
    "coords": 4.0,
    "square": 1.0,
    "dist_means": 0.0,
}

#: The same table for a feature-backed session (condensed production —
#: the square D never exists):
#:   condensed — the tiled production writes m ≈ ½n² entries once (its
#:               O(n·d) feature reads are ``production_floats``, charged
#:               as their own op since both modes pay them identically)
#:   operator  — wraps the production sweep's fused accumulators: free
#:   coords    — 4 fsvd matvecs, each reading condensed storage (½ pass)
FEATURE_HOIST_PASSES = dict(HOIST_PASSES,
                            condensed=0.5, operator=0.0, coords=2.0)


def hoist_floats(artifact: str, n: int, table: Optional[dict] = None
                 ) -> float:
    """fp32 floats moved building ``artifact`` once, per the registry
    (artifacts outside the table — ad-hoc cache keys — charge 0)."""
    t = HOIST_PASSES if table is None else table
    return t.get(artifact, 0.0) * float(n) * float(n)


def perm_traffic_floats(n: int, batch: int) -> dict:
    """Audited analytic fp32 floats moved PER PERMUTATION by each
    formulation of the Mantel-family inner loop (the ``BENCH_mantel``
    accounting — the 10.97x headline is
    ``square_gather / condensed_fused`` at n=2048, B=32):

    * ``original`` (paper Algorithm 3, eager): two materializing square
      gathers (4 n²-passes), the triangle condense (2m), and black-box
      pearsonr's multi-pass mean/center/norm/dot over both m-vectors
      (~8m) ⇒ 4n² + 10m floats;
    * ``square_gather`` (the pre-condensed engine loop): per
      permutation, ``x[order][:, order]`` lowers to two materialized n²
      gathers (read + write each) and the fused reduce reads the
      gathered Xp plus the square hoisted Ŷ ⇒ 6n² floats;
    * ``condensed_fused`` (the ``kernels.permute_reduce`` loop): one
      closed-form condensed gather (m) plus the per-permutation share
      of the tile streams — ŷ_c and the ii/jj triangle map, each
      fetched once per B-permutation tile (3m/B) — plus the (n,) order
      row ⇒ m(1 + 3/B) + n floats.
    """
    m = n * (n - 1) // 2
    return {
        "original": 4 * n * n + 10 * m,
        "square_gather": 6 * n * n,
        "condensed_fused": m * (1.0 + 3.0 / batch) + n,
    }


#: outputs (rows × permutations) one ``permute_reduce`` launch takes on
#: the card (``kernels.permute_reduce.MAX_OUTPUTS``, pinned equal by the
#: tests): a tile of S·B above it runs in several launches
ROW_STATIONARY_OUTPUTS = 128


def row_stationary_launches(batch: int, s: int = 1) -> tuple[int, int]:
    """(P, L): permutations a launch, P = min(B, 128/S), and launches a
    tile, L = ⌈B/P⌉, of the card's ``permute_reduce``."""
    per_launch = max(min(batch, ROW_STATIONARY_OUTPUTS // s), 1)
    return per_launch, -(-batch // per_launch)


def row_stationary_floats(n: int, batch: int, s: int = 1) -> float:
    """fp32 floats moved PER PERMUTATION by the card's row-stationary
    ``permute_reduce`` (``csrc/permute_reduce.cu``) on a tile of B
    permutations with S invariant rows: each launch reads the condensed x
    once (m), each permutation reads the S rows of ys once (S·m), and its
    order rows take 8n bytes (2n floats), PERF.md's model of a tile,
    4m(S·B + L) + 8nB bytes: (m·(S·B + L) + 2nB) / B floats a
    permutation, L = ⌈B/P⌉ launches a tile."""
    m = n * (n - 1) // 2
    _, launches = row_stationary_launches(batch, s)
    return (float(m) * (s * batch + launches) + 2.0 * n * batch) / batch


def within_sums_floats(n: int, batch: int) -> float:
    """fp32 floats moved PER PERMUTATION by the card's ``within_sums``
    (``csrc/within_sums.cu``), ANOSIM's tile of B permutations: the bytes
    its launches declare (``kernels.within_sums.tile_cost``: the ranks read
    once, each tile's permuted codes, the orders' inversion) over 4B, the
    grid's O(B) partials left out."""
    return within_sums_tile_cost(n, batch, 0)[0] / (4.0 * batch)


def production_floats(n: int, d: int, block: int) -> float:
    """Feature reads of the tiled pairwise production: each of the
    ⌈n/b⌉ row panels streams the full (n, d) table against its own
    (b, d) panel ⇒ ⌈n/b⌉·n·d + n·d floats. The m-element condensed
    write is the ``condensed`` hoist charge, not double-counted here."""
    b = max(min(block, n), 1)
    panels = -(-n // b)
    return float(panels) * n * d + float(n) * d


def sparse_production_floats(n: int, d: int, block: int, nnz: int,
                             rows: int) -> float:
    """Reads of the sparse-support production (``dist/driver.py``), in
    4-byte words: the nonzero count and the compressed copy's selection
    each read the table once (2·n·d); then each group of ``rows`` panel
    rows streams every nonzero (index and value) and two row offsets a
    table row, Σ over panels of ⌈b_p / rows⌉·(2·nnz + 2·n)."""
    b = max(min(block, n), 1)
    groups = sum(-(-min(b, n - i0) // rows) for i0 in range(0, n, b))
    return 2.0 * n * d + float(groups) * (2.0 * nnz + 2.0 * n)


# --------------------------------------------------------------------------
# The runtime ledger
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LedgerEntry:
    """One charge: operation name, fp32 floats moved, and the parameter
    point ((n, d, K, B, block, …)) the cost term was evaluated at."""

    op: str
    floats: float
    params: dict

    @property
    def bytes(self) -> float:
        return 4.0 * self.floats

    def to_dict(self) -> dict:
        return {"op": self.op, "floats": self.floats, "bytes": self.bytes,
                "params": dict(self.params)}


class Ledger:
    """A session's running analytic traffic account.

    Charged by the instrumented call sites (HoistCache builds, the
    engine's permutation batches, the production sweep); ``totals()``
    is what ``RunReport`` embeds. Charges are analytic — exact
    functions of the documented parameters — never measured, so they
    are noise-free and reproducible offline.
    """

    def __init__(self):
        self.entries: list[LedgerEntry] = []

    # -- charging ----------------------------------------------------------
    def charge(self, op: str, floats: float, **params) -> LedgerEntry:
        e = LedgerEntry(op, float(floats), params)
        self.entries.append(e)
        return e

    def charge_hoist(self, artifact: str, n: int,
                     table: Optional[dict] = None) -> LedgerEntry:
        """One artifact build, per the pass registry (``table`` selects
        the square-backed vs feature-backed column)."""
        t = HOIST_PASSES if table is None else table
        passes = t.get(artifact, 0.0)
        return self.charge(f"hoist:{artifact}", passes * float(n) * n,
                           n=n, passes=passes)

    def charge_perm_batch(self, op: str, n: int, permutations: int,
                          batch: int, model: str = "condensed_fused",
                          **params) -> LedgerEntry:
        """One permutation run of ``permutations`` draws in B=``batch``
        tiles, per the audited per-permutation model
        (``model="row_stationary"`` reads the invariant rows ``s``, default
        1, from ``params``; ``"within_sums"`` is ANOSIM's kernel on the
        card)."""
        if model == "row_stationary":
            per_perm = row_stationary_floats(n, batch, params.get("s", 1))
        elif model == "within_sums":
            per_perm = within_sums_floats(n, batch)
        else:
            per_perm = perm_traffic_floats(n, batch)[model]
        return self.charge(f"perm:{op}", per_perm * permutations, n=n,
                           permutations=permutations, batch=batch,
                           model=model, floats_per_perm=per_perm, **params)

    def charge_production(self, n: int, d: int, block: int,
                          route: str = "dense", **params) -> LedgerEntry:
        """The production's reads by the route it took: the dense panel
        sweep (its entry the reference's), or the sparse-support sweep
        (``nnz`` and ``rows`` in ``params``, ``route`` in the entry)."""
        if route == "dense":
            return self.charge("production", production_floats(n, d, block),
                               n=n, d=d, block=block, **params)
        return self.charge("production", sparse_production_floats(
            n, d, block, params["nnz"], params["rows"]), n=n, d=d,
            block=block, route=route, **params)

    # -- queries -----------------------------------------------------------
    def total_floats(self) -> float:
        return sum(e.floats for e in self.entries)

    def total_bytes(self) -> float:
        return 4.0 * self.total_floats()

    def hoist_passes(self) -> float:
        """Total n²-passes across every hoist charge — the quantity the
        ``BENCH_api`` 11-vs-16 session accounting tracks."""
        return sum(e.params.get("passes", 0.0) for e in self.entries
                   if e.op.startswith("hoist:"))

    def by_op(self) -> dict:
        out: dict = {}
        for e in self.entries:
            d = out.setdefault(e.op, {"count": 0, "floats": 0.0,
                                      "bytes": 0.0})
            d["count"] += 1
            d["floats"] += e.floats
            d["bytes"] += e.bytes
        return out

    def totals(self) -> dict:
        return {"by_op": self.by_op(),
                "total_floats": self.total_floats(),
                "total_bytes": self.total_bytes(),
                "hoist_passes": self.hoist_passes()}

    def to_dict(self) -> dict:
        d = self.totals()
        d["entries"] = [e.to_dict() for e in self.entries]
        return d
