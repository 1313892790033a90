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

Under an observing session the sweep runs in a ``dist.pairwise_condensed``
span and charges the ledger's feature reads; each panel step (the launch,
the running sums, the strip's selection) runs in a ``dist.panel`` span,
which a recording profiler sees without a session, and notes its call as
``dist.panel_stats``. ``Workspace.from_features`` is the session
that consumes a production: its condensed vector, operator means and
Mantel moments.
"""

from __future__ import annotations

import torch

from repro_torch.dist.metrics import get_metric
from repro_torch.kernels.dispatch import (DeviceLike, clamp_block,
                                          resolve_device)
from repro_torch.kernels.pairwise_ops import pairwise_panel_op
from repro_torch.obs.compile import note_trace
from repro_torch.obs.trace import current_obs

DEFAULT_BLOCK = 256


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
                  block=b, metric=metric.name, panels=-(-n // b)):
        for i0 in range(0, n, b):
            i1 = min(i0 + b, n)
            with current_obs().span("dist.panel", i0=i0, rows=i1 - i0):
                strip, rs1, rs2 = _panel_stats(x[i0:i1], x, metric)
                rowsum_d[i0:i1] = rs1
                rowsum_d2[i0:i1] = rs2
                upper = (cols[None, :]
                         > torch.arange(i0, i1, device=dev)[:, None])
                condensed[row_start(n, i0):row_start(n, i1)] = strip[upper]
    obs.charge_production(n, d, b, metric=metric.name)

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
