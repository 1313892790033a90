"""Panel-by-panel pairwise-distance driver with fused hoist accumulation.

The counterpart of ``repro/dist/driver.py``. An (n, d) feature table
becomes condensed distances one row panel at a time, and the O(n²) hoists
that are running sums are taken from each panel while it is resident:

* the **condensed** form (scipy ``pdist`` layout): the upper-triangle
  entries of rows [i0, i1) are one contiguous condensed range, the
  strip's strict upper triangle in row-major order, selected by the mask
  ``cols > rows`` (no index array is built or copied);
* the **operator means** — the row and global means of E = −½ D∘D that
  ``CenteredGramOperator.from_distance`` hoists from a square D — from
  each strip's row sums of D²;
* the **condensed moments** — mean and centred norm of the condensed
  vector, the permuted-side hoist of the Mantel family — from the same
  row sums (Σ over the full hollow matrix is twice the condensed Σ).

Peak memory is one (block, n) strip plus the (m,) condensed output,
m = n(n−1)/2; the square is never allocated. Each panel is one
``pairwise_panel_op`` call: on the card one launch of the
``pairwise_panel`` kernel, on the CPU its plain version. The scalar
moments are summed in fp64 from the n fp32 row sums and rounded to fp32
(the reference sums in fp32): ``Σd² − m·mean²`` cancels, and fp64 keeps
the card and the CPU within 1e-5 of each other.

**The sparse-support route.** A count table is mostly zeros (16S OTU
tables: about 1% nonzero), and Bray–Curtis needs only one row of each
pair's nonzeros: for any signs the zeros of b add nothing to

    Σ_f |a_f − b_f| = Σ_{f ∈ supp b} (|a_f − b_f| − |a_f|) + Σ_f |a_f|,

and likewise for Σ_f |a_f + b_f|. So a condensed Bray–Curtis production
whose table's nonzero share is below ``SPARSE_SHARE`` first makes the
table's compressed copy (``kernels.pairwise_ops.row_support``: row
offsets, feature indices and values, ≈ 22 MB at the HMP V3-V5 table's
4743 × 45383 and 1.3% nonzero), on the table's device, and each panel is
summed over it (``pairwise_sparse_panel`` on the card, its plain version
on the CPU). The rule, :func:`production_route`, reads only the input:
the metric, the share (one counting pass, a synchronisation) and whether
the fullest row fits the kernel's shared memory
(``kernels.pairwise.sparse_rows``); the probe and the session's report
ask it too. The copy lives
for this production alone: made before the panel loop, dropped before the
call returns, never cached, since each production is asked for afresh.
Every other metric, and a table at or above the share, takes the dense
``pairwise_panel`` kernel as before, bit for bit; so does
``pairwise_distances(out="square")``, whose exact symmetry needs d(i, j)
and d(j, i) to be the same expression, which the sum over supp b is not.
On integer counts the two routes give the same bits (every partial sum is
an exact integer in fp32).

Under an observing session the sweep runs in a ``dist.pairwise_condensed``
span, with attributes ``route`` (``"sparse"`` or ``"dense"``) and
``nonzero_share`` (``None`` for a metric the route never takes), and
charges the ledger the reads of the route it took; the compressed copy is
made in a ``dist.row_support`` span, so a profile shows each production
that took the route. Each panel step (the launch, the running sums, the
strip's selection) runs in a ``dist.panel`` span, which a recording
profiler sees without a session, and notes its call as
``dist.panel_stats``. ``Workspace.from_features`` is the session that
consumes a production: its condensed vector, operator means and Mantel
moments.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.dist.metrics import get_metric
from repro_torch.kernels.dispatch import (DeviceLike, clamp_block,
                                          resolve_device)
from repro_torch.kernels.pairwise import sparse_rows
from repro_torch.kernels.pairwise_ops import (SparseBrayCurtis,
                                              pairwise_panel_op,
                                              row_nonzeros, row_support)
from repro_torch.obs.compile import note_trace
from repro_torch.obs.trace import current_obs

DEFAULT_BLOCK = 256

#: The nonzero share below which a condensed Bray–Curtis production takes
#: the sparse-support route. Measured on an H100 (700 W) with both routes
#: at n = 4743, d = 45383, integer counts (``chip_smoke.py
#: --sparse-crossover``): whole productions of 0.011, 0.018, 0.041, 0.060,
#: 0.069, 0.088 and 0.110 s by the sparse route at 1, 2, 5, 8, 10, 12 and 15%
#: nonzero, against 0.229–0.237 s by the dense one; at 20% (one held row a
#: block) 0.247 s against 0.234, and 0.357 against 0.237 at 30%. The
#: threshold is the last share at which the sparse route still won.
SPARSE_SHARE = 0.15


def condensed_size(n: int) -> int:
    """m = n(n−1)/2, the scipy ``pdist`` condensed length."""
    return n * (n - 1) // 2


def row_start(n: int, i: int) -> int:
    """Condensed position of row i's first entry: i(2n − i − 1)/2 (row r
    owns a run of n − 1 − r entries)."""
    return i * (2 * n - i - 1) // 2


def _table(x, device: torch.device) -> torch.Tensor:
    x = torch.as_tensor(x).to(device=device, dtype=torch.float32)
    if x.ndim != 2:
        raise ValueError(f"expected an (n, d) feature table, got "
                         f"{tuple(x.shape)}")
    return x.contiguous()


def _panel_stats(xi: torch.Tensor, x: torch.Tensor, metric):
    """One row strip and its running sums: (strip, Σ_j d, Σ_j d²)."""
    note_trace("dist.panel_stats", (tuple(xi.shape), tuple(x.shape),
                                    metric.name, x.device.type))
    strip = pairwise_panel_op(xi, x, metric)
    return strip, torch.sum(strip, dim=1), torch.sum(strip * strip, dim=1)


class ProductionRoute(NamedTuple):
    """``"sparse"`` or ``"dense"``; the table's nonzero ``share``, ``nnz``,
    fullest row and each row's nonzeros (``counts``, for the compressed
    copy), None or 0 for a metric the sparse route never takes."""

    route: str
    share: Optional[float]
    nnz: int
    max_row: int
    counts: Optional[torch.Tensor]


def production_route(x: torch.Tensor, metric) -> ProductionRoute:
    """The route of a condensed production of the contiguous fp32 table
    ``x`` under ``metric``: sparse for
    Bray–Curtis below ``SPARSE_SHARE`` nonzero when the fullest row fits
    the sparse kernel, else dense. One counting pass over the table and
    one synchronisation, for Bray–Curtis only."""
    n, d = x.shape
    if (metric.name != "braycurtis" or not 0 < n * d < 2 ** 31
            or d >= 2 ** 24):
        return ProductionRoute("dense", None, 0, 0, None)
    counts = row_nonzeros(x)
    nnz, max_row = torch.stack([counts.sum(), counts.max()]).tolist()
    share = nnz / (n * d)
    sparse = share < SPARSE_SHARE and sparse_rows(d, max_row) > 0
    return ProductionRoute("sparse" if sparse else "dense", share, nnz,
                           max_row, counts)


def pairwise_condensed(x, metric="braycurtis", *, block: int = DEFAULT_BLOCK,
                       device: DeviceLike = None) -> dict:
    """Condensed distances and fused hoists from an (n, d) feature table,
    on ``device`` (``None``: the card).

    Returns a dict with the reference's keys:

    * ``condensed``   — (m,) scipy-pdist-layout distances, fp32;
    * ``row_means``   — (n,) row means of E = −½ D∘D;
    * ``global_mean`` — () global mean of E;
    * ``mean`` / ``norm`` — condensed mean and centred condensed norm;
    * ``n`` / ``metric`` — provenance.
    """
    metric = get_metric(metric)
    dev = resolve_device(device)
    x = _table(x, dev)
    n, d = x.shape
    b = clamp_block(n, block)
    m = condensed_size(n)
    obs = current_obs()          # the ambient session (NULL_OBS when none)
    condensed = torch.empty((m,), dtype=torch.float32, device=dev)
    rowsum_d = torch.empty((n,), dtype=torch.float32, device=dev)
    rowsum_d2 = torch.empty((n,), dtype=torch.float32, device=dev)
    cols = torch.arange(n, device=dev)
    with obs.span("dist.pairwise_condensed", phase="production", n=n, d=d,
                  block=b, metric=metric.name,
                  panels=-(-n // b)) as span:
        route, support = production_route(x, metric), None
        if route.route == "sparse":
            with current_obs().span("dist.row_support", n=n, d=d,
                                    nnz=route.nnz):
                support = row_support(x, route.counts, route.max_row)
        span.add(route=route.route, nonzero_share=route.share)
        panel_metric = metric if support is None else \
            SparseBrayCurtis(support)
        for i0 in range(0, n, b):
            i1 = min(i0 + b, n)
            with current_obs().span("dist.panel", i0=i0, rows=i1 - i0):
                strip, rs1, rs2 = _panel_stats(x[i0:i1], x, panel_metric)
                rowsum_d[i0:i1] = rs1
                rowsum_d2[i0:i1] = rs2
                upper = (cols[None, :]
                         > torch.arange(i0, i1, device=dev)[:, None])
                condensed[row_start(n, i0):row_start(n, i1)] = strip[upper]
    sparse = {} if support is None else {
        "nnz": route.nnz, "rows": sparse_rows(d, route.max_row)}
    del support, panel_metric
    obs.charge_production(n, d, b, metric=metric.name, route=route.route,
                          **sparse)

    row_means = -0.5 * rowsum_d2 / n
    sum_c = 0.5 * torch.sum(rowsum_d.double())
    sumsq_c = 0.5 * torch.sum(rowsum_d2.double())
    mean_c = sum_c / max(m, 1)
    norm = torch.sqrt(torch.clamp_min(sumsq_c - m * mean_c * mean_c, 0.0))
    return {"condensed": condensed, "row_means": row_means,
            "global_mean": torch.mean(row_means.double()).float(),
            "mean": mean_c.float(), "norm": norm.float(), "n": n,
            "metric": metric.name}


def pairwise_distances(x, metric="braycurtis", *, out: str = "square",
                       block: int = DEFAULT_BLOCK,
                       device: DeviceLike = None) -> torch.Tensor:
    """The ``scipy.spatial.distance.pdist``/``squareform`` replacement, on
    ``device`` (``None``: the card).

    ``out="square"`` assembles the full (n, n) matrix panel by panel,
    exactly symmetric and hollow by construction (d(i, j) and d(j, i) are
    the same expression); ``out="condensed"`` is the pdist layout through
    ``pairwise_condensed`` (no n×n allocated).
    """
    if out == "condensed":
        return pairwise_condensed(x, metric, block=block,
                                  device=device)["condensed"]
    if out != "square":
        raise ValueError(f"out must be 'square' or 'condensed', got {out!r}")
    metric = get_metric(metric)
    dev = resolve_device(device)
    x = _table(x, dev)
    n = x.shape[0]
    b = clamp_block(n, block)
    square = torch.empty((n, n), dtype=torch.float32, device=dev)
    for i0 in range(0, n, b):
        square[i0:i0 + b] = pairwise_panel_op(x[i0:i0 + b], x, metric)
    return square
