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
loads and stores its wrapper declares. Ratios quoted below are
measured / expected, on this container's CPU (torch 2.13).

* ``kernels.permute_reduce``, one tile of B permutations with S rows.
  CPU, the plain chunked version (regime ``plain-chunked``): per chunk
  of c positions, the two triangle-map widenings (24c), the two order
  gathers (16Bc), min/max and the six int32 ops of the triangle index
  (92Bc), its widening and the xc gather (20Bc), the fp64 copies of the
  gathered tile and of ys (12Bc + 12Sc), and the product (8Sc + 8Bc):
  c(24 + 20S + 148B) bytes a chunk over the padded length, plus the
  padding copies of ys, ii and jj and about 91 bytes an order element
  for the plain ``inverse_orders``. Measured 1.000 (n = 2048, B = 32).
  Card, the row-stationary kernels (``row-stationary``): each of the L
  partials launches of P permutations loads the condensed x twice (the
  run and the column of each row, 8m bytes), m floats of each ys row
  and m 16-bit order values a permutation, and one inv entry a (row,
  permutation); ``inverse_orders`` loads each order row once a block of
  its cluster (``cluster_size``) and stores 6n bytes a row. The fp64
  partials, S·P a block, depend on the grid the card holds at once (at
  most n blocks): the band runs from none to n blocks' worth. The
  measured side is, by construction, the same count: the launches
  declare it (``kernels/permute_reduce.py::partials_cost``). What the
  verdict checks is which launches ran, and that nothing else in the call
  moves bytes at the tile's scale. Against the ledger's row-stationary model
  (4m(S·B + L) + 8nB, which counts x and the order rows once) the ratio
  is about 1.5 at S = 1, B = 32: the column loads of x and the order
  walks come mostly from L2.
  Peak: arguments + outputs up to the known temporaries (CPU: one
  chunk's intermediates, 64Bc + (16 + 8S)c, the padded copies and the
  inverse's 40Bn; card: inv and the 16-bit orders, 6Bn, the fp64
  partials and the allocator's rounding).
* ``dist.panel_stats``, one strip of b rows of an (n, d) table. CPU, the
  plain panel (``plain``): the metric's broadcast terms over (8, n, 128)
  sub-panel chunks, ``_PLAIN_TERM_BYTES`` bytes a (row, column, feature)
  term (Bray–Curtis: a−b, its abs and sum, a+b, its abs and sum, 32),
  plus the reads of the x chunk by the ops that broadcast it (4 bytes
  each per 8 rows): the lower edge. The per-strip-element work above it
  (each chunk's sums and their merges, the finish, the concatenation and
  the running sums: 33–238 bytes a strip element measured over the five
  metrics and 1–3 feature chunks) is bounded by 64 + 100 bytes a strip
  element and feature chunk: the upper edge, an envelope. Measured 1.01–
  1.05 of the lower edge at (1000, 130, 256), up to 1.95 at (16, 4, 16)
  where the strip's work outweighs the terms. Card, one ``pairwise_panel`` launch
  (``kernel``): the tile blocks read xi ceil(n/64) times and x
  ceil(b/64) times and store the strip once; the running sums read and
  write 24 bytes a strip element. The kernel's part is, by construction,
  its declared count.
  Peak: arguments + outputs up to five (8, n, 128) fp32 intermediates
  and two strips on the CPU; up to one strip and the allocator's
  rounding on the card.
* ``kernels.center_matvec``, one matvec of the square operator. CPU, the
  plain version (``plain``): −½D∘D in two passes, its fp64 copy and the
  fp64 product, 40n² bytes, and about 72nk for the corrections and the
  casts; measured 1.000–1.003. Card, one ``center_matvec`` launch
  (``kernel``): one D pass, X read by each of the ceil(n/128) blocks, the
  corrections' few passes over X: tight, the kernel's part by
  construction its declared count. Peak: up to the fp32 E and its fp64
  copy on the CPU, the allocator's rounding on the card.
* ``tune.stream_pass``: exactly 8 bytes an element on both devices (one
  kernel reads and writes one fp32 an element). Measured 1.0 exactly.

Slack is kept per backend, as the reference keeps it. ``"cpu"`` is set
from the CPU runs above: the tight forms land within 1.000–1.004 of
their value from n = 40 up and 1.038 at n = 12 (the center matvec's
O(n) terms), so (0.95, 1.05). ``"cuda"`` started at the reference's
accelerator slack (0.5, 2.0) and was narrowed from the card's ratios at
n = 16384 (``chip_smoke.py`` phase 3d on an H100, PERF.md): the tight
byte counts landed 1.0000000 (the panel), 1.0000091 (the center matvec)
and 1.00024 (permute_reduce, whose form then left out the inverse's
cluster re-reads and the partials) of their values, every peak inside
its envelope, so (0.99, 1.01). At n = 512 those two left-out terms made
1.3% and failed the card test: both are in the form now, against which
the n = 16384 reading is 1.0000051 (the partials of a 264-block grid). With ``backend=None`` the sentinel judges each record by the
device it ran on; a sentinel told one backend refuses a record of
another.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.kernels.center_matvec import STRIP_ROWS
from repro_torch.kernels.inverse_orders import cluster_size
from repro_torch.kernels.pairwise import TILE
from repro_torch.obs.ledger import (perm_traffic_floats, production_floats,
                                    row_stationary_floats,
                                    row_stationary_launches)

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
            per_launch, launches = row_stationary_launches(B, s)
            floor = 4.0 * B * row_stationary_floats(n, B, s)
            # partials: x twice, ys once and the 16-bit orders' walk once a
            # permutation, an inv entry a (row, permutation); the inverse:
            # each order row once a block of its cluster, 6n bytes stored;
            # the fp64 partials (a block's S·P, at most n blocks a launch)
            # stored and read by the finish, and the O(B) rest (the finish's
            # sums, their concatenation, the permutation check): the band's
            # width
            eff = (4.0 * m * (2 * launches + s * B) + 2.0 * m * B
                   + 4.0 * n * B * (cluster_size(B, n) + 2.5))
            lo, hi = eff, eff + 16.0 * s * B * n + 32.0 * (s + 1) * B
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
        floor = 4.0 * production_floats(n, d, b) / max(-(-n // b), 1)
        if rec.backend == "cuda":
            eff = (4.0 * d * (-(-n // TILE) * b + -(-b // TILE) * n)
                   + 24.0 * b * n + 8.0 * b)
            temp = 4.0 * b * n + _ALLOCATOR_BYTES
            regime, note = "kernel", "tight: declared launch + running sums"
        else:
            metric = p.get("metric", "braycurtis")
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

    # -- center-matvec -----------------------------------------------------
    def check_center_matvec(self, rec) -> List[DriftVerdict]:
        p = rec.params
        n, k = int(p["n"]), int(p["k"])
        floor = 4.0 * (n * n + 2 * n * k + 2 * n)   # D + x + out + vecs
        if rec.backend == "cuda":
            eff = 4.0 * (n * n + (-(-n // STRIP_ROWS) + 3) * n * k + 2 * n)
            temp = float(_ALLOCATOR_BYTES)
            regime, note = "kernel", "tight: one D pass"
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
