"""Measured-vs-modeled reconciliation: the DriftSentinel.

The counterpart of ``repro/obs/drift.py``. ``obs.probe`` counts what one
call of a program moves; ``obs.ledger`` says what the streaming model
*prices*. This module reconciles each probe record with a closed form of
the port's own program and judges it against a per-backend tolerance
band; the verdicts ride ``RunReport.drift``. Every verdict carries
``ratio`` = measured / floor, the implementation's inflation over the
ledger's ideal streaming count.

The bands are the port's, derived from the port's programs. The
reference's closed forms describe XLA's scan, which the port does not
run. Each band is tight: the closed form of what the program moves, one
value, widened only by the backend's slack. Bytes are counted as
``obs.probe`` counts them: every aten op its operands read in full and
its outputs written, gathers twice their output; a kernel launch the
loads and stores its wrapper declares.

**On the card** a program's expected bytes are its launches' declared
costs at the record's geometry (the launch modules' ``*_cost``, the one
statement of each kernel's traffic: ``permute_reduce.tile_cost``,
``pairwise_cost`` or ``sparse_cost``, ``center_matvec_cost``) plus the
closed form of the aten ops around them (a panel's running sums; the
matvec's corrections, ``center_corrections``), so a verdict checks which
launches ran and that nothing else moves bytes at the program's scale. A
tile's fp64 partials depend on the grid the card holds at once: its band
runs from no block to n blocks, plus the O(B) rest. Peaks: the known
temporaries and the caching allocator's rounding.

**On the CPU** the plain versions run, which no launch declares; ratios
quoted are measured / expected on a CPU (torch 2.13).

* ``kernels.permute_reduce``, the plain chunked version (regime
  ``plain-chunked``): per chunk of c positions, the two triangle-map
  widenings (24c), the two order gathers (16Bc), min/max and the six
  int32 ops of the triangle index (92Bc), its widening and the xc gather
  (20Bc), the fp64 copies of the gathered tile and of ys (12Bc + 12Sc),
  and the product (8Sc + 8Bc): c(24 + 20S + 148B) bytes a chunk over the
  padded length, plus the padding copies of ys, ii and jj and about 91
  bytes an order element for the plain ``inverse_orders``. Measured 1.000
  (n = 2048, B = 32). Peak: one chunk's intermediates, 64Bc + (16 + 8S)c,
  the padded copies and the inverse's 40Bn.
* ``dist.panel_stats``, the plain dense panel (``plain``): the metric's
  broadcast terms over (8, n, 128) sub-panel chunks,
  ``_PLAIN_TERM_BYTES`` bytes a (row, column, feature) term (Bray–Curtis:
  a−b, its abs and sum, a+b, its abs and sum, 32), plus the reads of the
  x chunk by the ops that broadcast it (4 bytes each per 8 rows): the
  lower edge. The per-strip-element work above it (33–238 bytes a strip
  element measured over the five metrics and 1–3 feature chunks) is
  bounded by 64 + 100 bytes a strip element and feature chunk: the upper
  edge. Measured 1.01–1.05 of the lower edge at (1000, 130, 256), up to
  1.95 at (16, 4, 16). Peak: five (8, n, 128) fp32 intermediates and two
  strips. The plain sparse panel (``plain-sparse``), 8 rows at a time:
  72 bytes a (panel row, nonzero) term, 24 a nonzero a chunk, 16 a panel
  row and feature, 92 a strip element, the copy's widening (36 a
  nonzero, 52 a row), and 24 for each of the panel rows' own e nonzeros:
  the band runs from e = 0 to min(nnz, b·max_row). Peak: four (8, nnz)
  terms, the widened indices, a dense chunk of rows and a strip.
* ``kernels.center_matvec``, the plain version (``plain``): −½D∘D in two
  passes, its fp64 copy and the fp64 product, 40n² bytes, and about 72nk
  for the corrections and the casts; measured 1.000–1.003. Peak: up to
  the fp32 E and its fp64 copy.
* ``tune.stream_pass``: exactly 8 bytes an element on both devices (one
  kernel reads and writes one fp32 an element). Measured 1.0 exactly.

Slack is kept per backend, as the reference keeps it. ``"cpu"`` is set
from the CPU runs above: the tight forms land within 1.000–1.004 of
their value from n = 40 up and 1.038 at n = 12 (the center matvec's
O(n) terms), so (0.95, 1.05). ``"cuda"`` started at the reference's
accelerator slack (0.5, 2.0) and was narrowed to (0.99, 1.01) from the
card's readings at n = 16384 (``chip_smoke.py`` phase 3d on an H100,
PERF.md), every peak inside its envelope. With ``backend=None`` the
sentinel judges each record by the device it ran on; a sentinel told one
backend refuses a record of another.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.dist.metrics import get_metric
from repro_torch.kernels.center_matvec import center_matvec_cost
from repro_torch.kernels.pairwise import pairwise_cost, sparse_cost
from repro_torch.kernels.permute_reduce import tile_cost
from repro_torch.obs.ledger import (perm_traffic_floats, production_floats,
                                    row_stationary_floats,
                                    row_stationary_launches,
                                    sparse_production_floats)

__all__ = ["DriftVerdict", "DriftSentinel", "reconcile"]

#: multiplicative slack on each band edge, per backend
_SLACK = {
    "cpu": (0.95, 1.05),
    "cuda": (0.99, 1.01),
}
_DEFAULT_SLACK = (0.5, 2.0)

#: bytes a (row, column, feature) term of the plain panel moves, by metric
#: (``dist/metrics.py``'s ``accumulate`` over (8, n, 128) chunks), and the
#: ops of each that read the broadcast x chunk
_PLAIN_TERM_BYTES = {"euclidean": 20, "cityblock": 16, "canberra": 60,
                     "braycurtis": 32, "jaccard": 20}
_PLAIN_X_READS = {"euclidean": 1, "cityblock": 1, "canberra": 3,
                  "braycurtis": 2, "jaccard": 2}
#: rows and features of one broadcast step of the plain panel
#: (``kernels/pairwise_ref.py``)
_ROW_CHUNK, _FEATURE_CHUNK = 8, 128
#: what the card's caching allocator may add to a call's peak: rounding
#: of each block and an unsplit cached block
_ALLOCATOR_BYTES = 8 * 2**20
#: bytes a strip element of the panel's running sums move: Σd (4), d·d
#: (12) and Σd² (4)
_RUNNING_SUMS = 20.0


@dataclasses.dataclass(frozen=True)
class DriftVerdict:
    """One reconciled quantity for one probed entry point.

    ``floor`` is the analytic ideal (ledger traffic, or arguments +
    outputs for a peak); ``expected_lo``/``expected_hi`` the
    slack-adjusted band; ``ratio`` = measured / floor; ``within`` whether
    measured landed inside the band.
    """

    name: str
    quantity: str               # "bytes" | "peak"
    measured: float
    floor: float
    expected_lo: float
    expected_hi: float
    regime: str
    within: bool
    note: str = ""

    @property
    def ratio(self) -> float:
        return self.measured / self.floor if self.floor else float("inf")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ratio"] = self.ratio
        return d


class DriftSentinel:
    """Reconciles ``obs.probe`` records against the port's closed forms.

    ``reconcile(records)`` takes the ``{name: ProbeRecord}`` mapping
    ``probe_session`` returns and emits the ``RunReport.drift`` section.
    Entry points without a closed form here (the matrix-free solve, the
    engine's statistic programs) stay measured-only.
    """

    def __init__(self, backend: Optional[str] = None,
                 slack: Optional[tuple] = None):
        self.backend = backend
        self._slack = tuple(slack) if slack is not None else None

    def slack_for(self, backend: str) -> tuple:
        """The slack a record run on ``backend`` is judged with."""
        if self.backend is not None and backend != self.backend:
            raise ValueError(f"a {self.backend} sentinel cannot judge a "
                             f"record run on {backend}")
        if self._slack is not None:
            return self._slack
        return _SLACK.get(backend, _DEFAULT_SLACK)

    # -- helpers -----------------------------------------------------------
    def _verdict(self, rec, quantity: str, measured: float, floor: float,
                 lo: float, hi: float, regime: str,
                 note: str = "") -> DriftVerdict:
        slo, shi = self.slack_for(rec.backend)
        lo, hi = lo * slo, hi * shi
        return DriftVerdict(name=rec.name, quantity=quantity,
                            measured=float(measured), floor=float(floor),
                            expected_lo=lo, expected_hi=hi, regime=regime,
                            within=bool(lo <= measured <= hi), note=note)

    def _peak(self, rec, temp: float, regime: str, note: str
              ) -> DriftVerdict:
        base = float(rec.argument_bytes + rec.output_bytes)
        return self._verdict(rec, "peak", rec.peak_bytes, base, base,
                             base + temp, regime, note)

    # -- permute_reduce ----------------------------------------------------
    def check_permute_reduce(self, rec) -> List[DriftVerdict]:
        p = rec.params
        n, B, s = int(p["n"]), int(p["batch"]), int(p.get("s", 1))
        m = n * (n - 1) // 2
        if rec.backend == "cuda":
            _, launches = row_stationary_launches(B, s)
            floor = 4.0 * B * row_stationary_floats(n, B, s)
            lo = tile_cost(n, s, B, 0)[0]
            hi = tile_cost(n, s, B, n)[0] + 32.0 * (s + 1) * B
            temp = 6.0 * n * B + 8.0 * s * B * min(n, 2048) * launches \
                + _ALLOCATOR_BYTES
            regime, note = ("row-stationary",
                            "tight: the launches' declared loads and stores")
        else:
            ch = int(p["chunk"])
            chunks = -(-m // ch)
            m_pad = chunks * ch
            floor = 4.0 * B * s * perm_traffic_floats(n, B)[
                "condensed_fused"]
            pad = 4.0 * (s + 2) * (m + m_pad) if m_pad > m else 0.0
            eff = m_pad * (24 + 20 * s + 148 * B) + pad + 91.0 * B * n
            lo = hi = eff
            temp = (ch * (64 * B + 16 + 8 * s) + 40.0 * B * n
                    + (4.0 * (s + 2) * m_pad if m_pad > m else 0.0))
            regime, note = ("plain-chunked",
                            "tight: c(24 + 20S + 148B) a chunk + inverse")
        bv = self._verdict(rec, "bytes", rec.bytes_corrected, floor, lo, hi,
                           regime, note)
        return [bv, self._peak(rec, temp, regime,
                               "args+out .. +known temporaries")]

    # -- distance production panel ----------------------------------------
    def check_panel(self, rec) -> List[DriftVerdict]:
        p = rec.params
        n, d, b = int(p["n"]), int(p["d"]), int(p["block"])
        panels = max(-(-n // b), 1)
        if p.get("route") == "sparse":
            return self._check_sparse_panel(rec, n, d, b, panels)
        floor = 4.0 * production_floats(n, d, b) / panels
        metric = p.get("metric", "braycurtis")
        if rec.backend == "cuda":
            eff = (pairwise_cost(b, n, d, get_metric(metric).kind)[0]
                   + _RUNNING_SUMS * b * n + 8.0 * b)
            temp = 4.0 * b * n + _ALLOCATOR_BYTES
            regime, note = "kernel", "tight: declared launch + running sums"
        else:
            eff = b * n * d * (_PLAIN_TERM_BYTES[metric]
                               + 4.0 * _PLAIN_X_READS[metric] / _ROW_CHUNK)
            chunks = max(-(-d // _FEATURE_CHUNK), 1)
            lo, hi = eff, eff + (64.0 + 100.0 * chunks) * b * n
            temp = 4.0 * (5 * min(b, _ROW_CHUNK) * n * min(d, _FEATURE_CHUNK)
                          + 2 * b * n)
            bv = self._verdict(rec, "bytes", rec.bytes_corrected, floor, lo,
                               hi, "plain",
                               f"envelope: {_PLAIN_TERM_BYTES[metric]} bytes "
                               f"a term + x reads, .. + the strip's sums")
            return [bv, self._peak(rec, temp, "plain",
                                   "args+out .. +5 broadcast chunks")]
        bv = self._verdict(rec, "bytes", rec.bytes_corrected, floor, eff,
                           eff, regime, note)
        return [bv, self._peak(rec, temp, regime, "args+out .. +one strip")]

    def _check_sparse_panel(self, rec, n: int, d: int, b: int,
                            panels: int) -> List[DriftVerdict]:
        p = rec.params
        nnz, rows, max_row = int(p["nnz"]), int(p["rows"]), int(p["max_row"])
        floor = 4.0 * sparse_production_floats(n, d, b, nnz, rows) / panels
        if rec.backend == "cuda":
            lo = hi = (sparse_cost(b, n, nnz, rows)[0]
                       + _RUNNING_SUMS * b * n + 8.0 * b)
            temp = 4.0 * b * n + _ALLOCATOR_BYTES
            regime, note = "sparse-kernel", \
                "tight: declared launch + running sums"
        else:
            r, chunks = min(b, _ROW_CHUNK), -(-b // _ROW_CHUNK)
            lo = (72.0 * b * nnz + 24.0 * chunks * nnz + 16.0 * b * d
                  + (72.0 + _RUNNING_SUMS) * b * n + 52.0 * b
                  + 32.0 * chunks + 36.0 * nnz + 52.0 * n + 12.0)
            hi = lo + 24.0 * min(nnz, b * max_row)
            temp = (16.0 * r * nnz + 16.0 * nnz + 24.0 * n + 64.0
                    + 4.0 * r * d + 8.0 * r * n + 4.0 * b * n)
            regime, note = "plain-sparse", \
                "tight: 72 bytes a term .. + the panel's own nonzeros"
        bv = self._verdict(rec, "bytes", rec.bytes_corrected, floor, lo, hi,
                           regime, note)
        return [bv, self._peak(rec, temp, regime,
                               "args+out .. +the terms and a strip")]

    # -- center-matvec -----------------------------------------------------
    def check_center_matvec(self, rec) -> List[DriftVerdict]:
        p = rec.params
        n, k = int(p["n"]), int(p["k"])
        floor = 4.0 * (n * n + 2 * n * k + 2 * n)   # D + x + out + vecs
        if rec.backend == "cuda":
            eff = (center_matvec_cost(n, n, k)[0] + 8.0 * n * k + 4.0 * n
                   + 36.0 * k + 4.0)
            temp = float(_ALLOCATOR_BYTES)
            regime, note = "kernel", "tight: declared launch + corrections"
        else:
            eff = 40.0 * n * n + 72.0 * n * k
            temp = 12.0 * n * n + 24.0 * n * k
            regime, note = "plain", "tight: E, its fp64 copy and product"
        bv = self._verdict(rec, "bytes", rec.bytes_corrected, floor, eff, eff,
                           regime, note)
        return [bv, self._peak(rec, temp, regime, "args+out .. +temporaries")]

    # -- calibration stream pass -------------------------------------------
    def check_stream(self, rec) -> List[DriftVerdict]:
        nbytes = 8.0 * int(rec.params["n"])         # read + write fp32
        return [self._verdict(rec, "bytes", rec.bytes_corrected, nbytes,
                              nbytes, nbytes, "stream",
                              "tight: 2 passes exactly")]

    # -- front door --------------------------------------------------------
    _CHECKS = {
        "kernels.permute_reduce": "check_permute_reduce",
        "dist.panel_stats": "check_panel",
        "kernels.center_matvec": "check_center_matvec",
        "tune.stream_pass": "check_stream",
    }

    def reconcile(self, records: Dict[str, object]) -> dict:
        """``RunReport.drift`` section for a ``probe_session`` result."""
        verdicts: List[DriftVerdict] = []
        for name, rec in sorted(records.items()):
            method = self._CHECKS.get(name)
            if method is not None:
                verdicts.extend(getattr(self, method)(rec))
        backends = {rec.backend for rec in records.values()}
        backend = self.backend or (backends.pop() if len(backends) == 1
                                   else None)
        return {
            "backend": backend,
            "slack": list(self.slack_for(backend)) if backend else None,
            "verdicts": [v.to_dict() for v in verdicts],
            "within_tolerance": all(v.within for v in verdicts),
        }


def reconcile(records: Dict[str, object],
              backend: Optional[str] = None) -> dict:
    """Module-level convenience: one-shot DriftSentinel reconcile."""
    return DriftSentinel(backend=backend).reconcile(records)
