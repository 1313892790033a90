"""Measurement of the session's programs (the MEASURED half).

The counterpart of ``repro/obs/probe.py``. Everything else in
``repro_torch.obs`` is analytic: the ledger prices pass tables,
``tune.model`` prices tiles. This module measures what a program
actually moves. The reference asks XLA: it compiles each jitted entry
point against abstract shapes and reads ``cost_analysis()``,
``memory_analysis()`` and the HLO text. The port has no compiler to ask,
so a probe runs ONE call of the program, on the session's device, on
synthetic inputs of the session's geometry (from a fixed seed), and
counts as it runs:

* **PyTorch ops**: a ``TorchDispatchMode`` charges every aten op with
  ``HloCostAnalysis``'s conventions. Each op reads its tensor operands in
  full and writes its outputs once. Views and metadata ops are free
  (``_FREE_OPS``, the counterpart of the reference's free HLO ops), and so
  is allocation: ``empty`` writes nothing. A gather- or scatter-type op
  (``_GATHER_OPS``, ``_SCATTER_OPS``) is charged twice the slice it
  moves, not its source;
  ``copy_`` reads its source and writes its destination; ``fill_`` and
  ``zero_`` only write.
* **Hand-written launches**: the kernels are bound with ``ctypes``, so
  dispatch never sees them. Each wrapper reports its launch to
  ``kernels._build.recorder`` with the bytes its kernel loads and stores
  in device memory (re-reads counted) and its operations, from a cost
  function of the launch's arguments beside the launch (the counterpart
  of a Pallas ``CostEstimate``). A launch that declares no cost fails the
  probe.
* **Operations**: ``torch.utils.flop_counter.FlopCounterMode`` over the
  same call, plus the launches' declared operations.
* **Peak memory**: on the card the caching allocator's
  ``max_memory_allocated()`` over the call, from a fresh peak (the probe
  resets the device's peak statistic), plus the arguments; on the CPU the counter's own sum of live storages (outputs
  added as they are created, freed through finalizers), its largest
  value. Either way argument + output + temp, as ``memory_analysis()``
  gives it.

An eager loop dispatches every iteration, so nothing is counted once for
many trips and ``bytes_corrected == bytes_accessed``. ``scan_trips``
keeps its place in the record: it maps each hand-written kernel the
probe saw launched more than once to its launch count, the counterpart
of a while body's trip count. The reference's HLO-text helpers
(``scan_corrected_bytes``, ``computation_multipliers``,
``body_once_bytes``) have no counterpart: there is no HLO.

A probe perturbs nothing of the session: it runs outside the ambient
``ObsSession`` (no span, no ledger charge) and with the call sentinel
suspended, leaves ``kernels._build.launches`` as it found them, frees its
inputs before it returns, and draws its inputs from its own generator.
Records are memoized by (entry point, device, parameters), so repeated
reports at one geometry run each probe once. Like every entry point, a
probe runs on the card unless ``device="cpu"`` is asked for.

Records are keyed by the sentinel's entry-point names
(``kernels.permute_reduce``, ``dist.panel_stats``, ...), so a
``RunReport``'s ``measured`` section lines up with its ``compile``
section. ``obs.drift`` owns the tolerance bands; this module only
measures.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (DeviceLike, clamp_block,
                                          resolve_device, snap_chunk)
from repro_torch.obs.compile import sentinel
from repro_torch.obs.trace import NULL_OBS, pop_obs, push_obs

__all__ = [
    "ProbeRecord", "probe_call",
    "probe_permute_reduce", "probe_panel_stats", "probe_center_matvec",
    "probe_pcoa_matfree", "probe_statistic", "probe_stream_pass",
    "probe_session", "probe_table", "clear_probe_cache",
]

#: the seed of every probe's synthetic inputs
SEED = 0

#: aten ops that move no data of their own: views, metadata, allocation
_FREE_OPS = frozenset({
    "view", "_unsafe_view", "expand", "t", "permute", "as_strided",
    "detach", "alias", "select", "slice", "transpose", "unsqueeze",
    "squeeze", "diagonal", "unfold", "split", "split_with_sizes",
    "unbind", "view_as_real", "view_as_complex", "_reshape_alias",
    "empty", "empty_strided", "empty_like", "new_empty", "lift_fresh",
    "lift_fresh_copy", "resize_", "set_",
})

#: ops charged twice the slice they move (``HloCostAnalysis``'s gather and
#: scatter convention): gathers by their output ...
_GATHER_OPS = frozenset({"index", "index_select", "gather", "take"})
#: ... scatters by the elements they write
_SCATTER_OPS = frozenset({"index_put", "index_put_", "_index_put_impl_",
                          "scatter", "scatter_", "scatter_add",
                          "scatter_add_", "index_add", "index_add_"})
#: ops that write their first operand and read nothing of it
_WRITE_ONLY_OPS = frozenset({"fill_", "zero_"})


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the elements a tensor (or view) spans."""
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _scatter_moved(func_name: str, args) -> int:
    """Bytes a scatter-type op writes: its index's elements (or its
    values', when larger, for ``index_put``), in the destination's
    dtype."""
    dst = args[0]
    if func_name.startswith(("index_put", "_index_put")):
        values = args[2]
        rows = max((t.numel() for t in _tensors(args[1])), default=0)
        return max(values.numel(), rows) * dst.element_size()
    index = args[2] if len(args) > 2 else None
    if isinstance(index, torch.Tensor):
        return index.numel() * dst.element_size()
    return _nbytes(dst)


class _Counter(TorchDispatchMode):
    """Bytes of every aten op, declared launches, and live storages (see
    the module docstring)."""

    def __init__(self, arguments: List[torch.Tensor], track_live: bool):
        super().__init__()
        self.bytes = 0.0
        self.launches: Dict[str, list] = {}
        self.track_live = track_live
        self._live: Dict[tuple, list] = {}
        self._finalizers: list = []
        self.live_bytes = self.peak_bytes = 0
        for t in arguments:                   # held for the whole call
            self._add(t)[1] += 1

    # -- live storages (the CPU's peak) ------------------------------------
    def _add(self, t: torch.Tensor) -> list:
        storage = t.untyped_storage()
        key = (str(t.device), storage.data_ptr())
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [storage.nbytes(), 0, key]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return entry

    def _hold(self, t: torch.Tensor) -> None:
        entry = self._add(t)
        entry[1] += 1
        self._finalizers.append(weakref.finalize(t, self._release, entry[2]))

    def _release(self, key: tuple) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._live[key]

    def close(self) -> None:
        """Stop tracking: detach every finalizer still pending."""
        for f in self._finalizers:
            f.detach()
        self._finalizers.clear()

    # -- declared launches --------------------------------------------------
    def launch(self, name: str, nbytes: float, flops: float) -> None:
        entry = self.launches.setdefault(name, [0, 0.0, 0.0])
        entry[0] += 1
        entry[1] += nbytes
        entry[2] += flops
        self.bytes += nbytes

    # -- aten ops -----------------------------------------------------------
    def _op_bytes(self, name: str, args, kwargs, outs) -> float:
        if name in _FREE_OPS:
            return 0.0
        if name in _GATHER_OPS:
            return 2.0 * sum(_nbytes(t) for t in outs)
        if name in _SCATTER_OPS:
            return 2.0 * _scatter_moved(name, args)
        if name in _WRITE_ONLY_OPS:
            return float(_nbytes(args[0]))
        if name == "copy_":
            return float(_nbytes(args[0]) + _nbytes(args[1]))
        reads = sum(_nbytes(t) for t in _tensors((args, kwargs)))
        return float(reads + sum(_nbytes(t) for t in outs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self.bytes += self._op_bytes(func.overloadpacket.__name__, args,
                                     kwargs, outs)
        if self.track_live:
            for t in outs:
                self._hold(t)
        return out


@dataclasses.dataclass(frozen=True)
class ProbeRecord:
    """One entry point, measured by one call (see module docstring).

    ``bytes_accessed`` is the counted traffic and ``bytes_corrected`` the
    same figure (an eager loop dispatches every trip); ``peak_bytes`` is
    argument + output + temp; ``scan_trips`` maps each hand-written kernel
    launched more than once to its launch count; ``launches`` maps every
    kernel launched to ``{"count", "bytes", "flops"}`` as its wrapper
    declared them. ``backend`` is the device type the probe ran on.
    """

    name: str
    backend: str
    flops: float
    bytes_accessed: float
    bytes_corrected: float
    peak_bytes: int
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    scan_trips: dict
    params: dict
    launches: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _storage_bytes(tensors: List[torch.Tensor]) -> int:
    """Bytes of the distinct storages behind ``tensors``."""
    seen = {}
    for t in tensors:
        s = t.untyped_storage()
        seen[(str(t.device), s.data_ptr())] = s.nbytes()
    return sum(seen.values())


def probe_call(name: str, fn: Callable, args, params: Optional[dict] = None
               ) -> ProbeRecord:
    """Run ``fn(*args)`` once under the counter and measure it. ``args``
    is a tuple of the call's operands (tensors, or objects holding them,
    such as an operator); its tensors are the argument bytes."""
    arguments = _tensors(args) + [
        t for a in args if not isinstance(a, torch.Tensor)
        for t in _held_tensors(a)]
    device = next((t.device for t in arguments if t.device.type == "cuda"),
                  torch.device("cpu"))
    argument_bytes = _storage_bytes(arguments)
    on_card = device.type == "cuda"
    launches_before = dict(_build.launches)
    counter = _Counter(arguments, track_live=not on_card)
    flop_counter = FlopCounterMode(display=False)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        start = torch.cuda.memory_allocated(device)
    push_obs(NULL_OBS)
    _build.recorder = counter.launch
    try:
        with sentinel.suspended(), flop_counter, counter:
            out = fn(*args)
        if on_card:
            torch.cuda.synchronize(device)
            peak = (torch.cuda.max_memory_allocated(device) - start
                    + argument_bytes)
        else:
            peak = counter.peak_bytes
        ran = {k: v - launches_before[k] for k, v in _build.launches.items()
               if v != launches_before[k]}
    finally:
        _build.recorder = None
        pop_obs(NULL_OBS)
        _build.launches.update(launches_before)
        counter.close()
    undeclared = {k: v for k, v in ran.items()
                  if counter.launches.get(k, [0])[0] != v}
    if undeclared:
        raise RuntimeError(f"{name}: launches {undeclared} declared no cost "
                           f"to the probe")
    output_bytes = _storage_bytes(_tensors(out))
    del out
    launches = {k: {"count": c, "bytes": b, "flops": f}
                for k, (c, b, f) in sorted(counter.launches.items())}
    return ProbeRecord(
        name=name, backend=device.type,
        flops=float(flop_counter.get_total_flops())
        + sum(v["flops"] for v in launches.values()),
        bytes_accessed=counter.bytes, bytes_corrected=counter.bytes,
        peak_bytes=int(peak), argument_bytes=argument_bytes,
        output_bytes=output_bytes,
        temp_bytes=int(peak) - argument_bytes - output_bytes,
        scan_trips={k: v["count"] for k, v in launches.items()
                    if v["count"] > 1},
        params=dict(params or {}), launches=launches)


def _held_tensors(value) -> List[torch.Tensor]:
    """The tensors a dataclass or plain object holds in its fields (an
    operator, a statistic), one level deep through dicts and sequences."""
    if dataclasses.is_dataclass(value):
        fields = [getattr(value, f.name) for f in dataclasses.fields(value)]
    else:
        fields = list(getattr(value, "__dict__", {}).values())
    return _tensors(fields)


#: process-level memo: repeated ``report()`` calls at one geometry run
#: each probe once
_MEMO: dict = {}


def clear_probe_cache() -> None:
    _MEMO.clear()


def _memoized(name: str, device: torch.device, params: dict,
              run: Callable[[], ProbeRecord]) -> ProbeRecord:
    key = (name, str(device), tuple(sorted(params.items())))
    if key not in _MEMO:
        _MEMO[key] = run()
    return _MEMO[key]


def _generator(device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(SEED)


def _orders(batch: int, n: int, gen: torch.Generator,
            device: torch.device) -> torch.Tensor:
    """(batch, n) int32 permutations of 0..n−1 from ``gen``."""
    keys = torch.rand((batch, n), generator=gen, device=device)
    return torch.argsort(keys, dim=1).to(torch.int32)


# --------------------------------------------------------------------------
# Entry-point probes
# --------------------------------------------------------------------------
def probe_permute_reduce(n: int, batch: int = 32, s: int = 1,
                         chunk: Optional[int] = None,
                         device: DeviceLike = None) -> ProbeRecord:
    """Measure ONE (B, n) tile of the batched condensed reduce, the program
    the engine's ``per_batch`` runs a tile: ``kernels.permute_reduce_ops.
    permute_reduce``. On the card ``inverse_orders``, the partials and the
    finish; on the CPU the plain chunked version in chunks of ``chunk``
    (``None``: the default, snapped as a session snaps it), with the
    int32 triangle maps handed in, as the reference hands them."""
    from repro_torch.core.distance_matrix import triangle_coords
    from repro_torch.kernels.permute_reduce import perms_per_launch
    from repro_torch.kernels.permute_reduce_ops import (DEFAULT_CHUNK,
                                                        permute_reduce)

    dev = resolve_device(device)
    m = n * (n - 1) // 2
    params = {"n": n, "batch": batch, "s": s}
    if dev.type == "cuda":
        if chunk is not None:
            raise ValueError("the card's permute_reduce takes no chunk")
        params.update(chunk=None,
                      perms_per_launch=perms_per_launch(s, batch))
    else:
        params["chunk"] = snap_chunk(m, DEFAULT_CHUNK if chunk is None
                                     else int(chunk))[0]

    def run() -> ProbeRecord:
        gen = _generator(dev)
        xc = torch.rand((m,), generator=gen, device=dev)
        ys = torch.rand((s, m), generator=gen, device=dev)
        orders = _orders(batch, n, gen, dev)
        if dev.type == "cuda":
            return probe_call("kernels.permute_reduce", permute_reduce,
                              (xc, ys, orders), params)
        ii, jj = triangle_coords(n, device=dev)
        return probe_call(
            "kernels.permute_reduce",
            lambda *a: permute_reduce(*a, chunk=params["chunk"]),
            (xc, ys, orders, ii, jj), params)

    return _memoized("kernels.permute_reduce", dev, params, run)


def _sparse_table(n: int, d: int, nnz: int, max_row: int,
                  gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """An (n, d) table of ``nnz`` nonzeros in [0.5, 1.5) at a stride a row,
    ``max_row`` in the first row and an even share of the rest in each."""
    rest, others = nnz - max_row, max(n - 1, 1)
    counts = torch.full((n,), rest // others, dtype=torch.int64,
                        device=device)
    counts[1:1 + rest % others] += 1
    counts[0] = max_row
    owner = torch.repeat_interleave(torch.arange(n, device=device), counts)
    starts = torch.cumsum(counts, 0) - counts
    stride = d // torch.clamp_min(counts, 1)[owner]
    slot = torch.arange(nnz, device=device) - starts[owner]
    x = torch.zeros((n, d), device=device)
    x[owner, slot * stride + owner % stride] = 0.5 + torch.rand(
        (nnz,), generator=gen, device=device)
    return x


def probe_panel_stats(n: int, d: int, block: int = 256,
                      metric: str = "braycurtis", device: DeviceLike = None,
                      nnz: Optional[int] = None,
                      max_row: Optional[int] = None) -> ProbeRecord:
    """Measure ONE row panel of the distance production sweep, the strip
    and its running sums (``dist.driver._panel_stats``): the
    ``pairwise_panel`` kernel on the card, its plain version on the CPU.
    Given ``nnz`` and ``max_row``, the panel of the sparse-support route
    (Bray–Curtis) instead, over the compressed copy of a table with
    ``nnz`` nonzeros whose fullest row holds ``max_row``: the
    ``pairwise_sparse_panel`` kernel on the card, its plain version on the
    CPU. The production runs ceil(n / block) of these."""
    from repro_torch.dist.driver import _panel_stats
    from repro_torch.dist.metrics import get_metric
    from repro_torch.kernels.pairwise import sparse_rows
    from repro_torch.kernels.pairwise_ops import (SparseBrayCurtis,
                                                  row_nonzeros, row_support)

    dev = resolve_device(device)
    b = clamp_block(n, block)
    params = {"n": n, "d": d, "block": b, "metric": metric, "route": "dense"}
    if nnz is not None:
        if metric != "braycurtis":
            raise ValueError(f"the sparse route is Bray–Curtis's, not "
                             f"{metric!r}'s")
        params.update(route="sparse", nnz=nnz, max_row=max_row,
                      rows=sparse_rows(d, max_row))

    def run() -> ProbeRecord:
        gen = _generator(dev)
        if nnz is None:
            xi = torch.rand((b, d), generator=gen, device=dev)
            x = torch.rand((n, d), generator=gen, device=dev)
            return probe_call(
                "dist.panel_stats",
                lambda a, c: _panel_stats(a, c, get_metric(metric)),
                (xi, x), params)
        x = _sparse_table(n, d, nnz, max_row, gen, dev)
        support = row_support(x, row_nonzeros(x), max_row)
        return probe_call(
            "dist.panel_stats",
            lambda t, s: _panel_stats(t[:b], t, SparseBrayCurtis(s)),
            (x, support), params)

    return _memoized("dist.panel_stats", dev, params, run)


def probe_center_matvec(n: int, k: int = 10,
                        device: DeviceLike = None) -> ProbeRecord:
    """Measure one matvec of the square-backed centred-Gram operator
    (``CenteredGramOperator.matvec``) over an (n, n) D and (n, k) X: the
    ``center_matvec`` kernel on the card, its plain version on the CPU."""
    from repro_torch.core.operators import CenteredGramOperator

    dev = resolve_device(device)
    params = {"n": n, "k": k}

    def run() -> ProbeRecord:
        gen = _generator(dev)
        d = torch.rand((n, n), generator=gen, device=dev)
        x = torch.rand((n, k), generator=gen, device=dev)
        row_means = torch.rand((n,), generator=gen, device=dev)
        op = CenteredGramOperator(d, row_means, row_means.mean(), n)
        return probe_call("kernels.center_matvec",
                          lambda o, v: o.matvec(v), (op, x), params)

    return _memoized("kernels.center_matvec", dev, params, run)


def probe_pcoa_matfree(op, k: int = 10, oversample: int = 10,
                       power_iters: int = 2,
                       device: DeviceLike = None) -> ProbeRecord:
    """Measure the matrix-free solve (``core.pcoa._subspace_iteration``)
    against a session's cached operator, which lies on ``device``, with a
    sketch of ``min(k + oversample, n)`` columns: the ``pcoa.fsvd_matfree``
    entry point."""
    from repro_torch.core.pcoa import _subspace_iteration

    dev = resolve_device(device)
    if op.row_means.device.type != dev.type:
        raise ValueError(f"the operator lies on {op.row_means.device}, "
                         f"not on {dev}")
    n = int(op.n)
    params = {"n": n, "k": k, "oversample": oversample,
              "power_iters": power_iters, "operator": type(op).__name__}

    def run() -> ProbeRecord:
        omega = torch.randn((n, min(k + oversample, n)),
                            generator=_generator(dev), device=dev)
        return probe_call(
            "pcoa.fsvd_matfree",
            lambda o, w: _subspace_iteration(o.matvec, w, k, power_iters),
            (op, omega), params)

    return _memoized("pcoa.fsvd_matfree", dev, params, run)


def probe_statistic(stat, batch: int = 32, device: DeviceLike = None
                    ) -> Dict[str, ProbeRecord]:
    """Measure one statistic's engine entry points on ``device`` (where its
    tensors lie): the hoist (``stats.engine.hoist_and_observe``) and one
    (B, n) tile of the per-batch program (``stats.engine.tile``)."""
    from repro_torch.stats import engine

    dev = resolve_device(device)
    n = int(stat.n)
    name = type(stat).__name__
    out = {}
    invariants = {}

    def hoist(st):
        invariants["value"], observed = engine.hoist_and_observe(st, dev)
        return observed

    out["stats.engine.hoist_and_observe"] = probe_call(
        "stats.engine.hoist_and_observe", hoist, (stat,),
        {"stat": name, "n": n})
    orders = _orders(batch, n, _generator(dev), dev)
    out["stats.engine.tile"] = probe_call(
        "stats.engine.tile",
        lambda st, o: engine.tile_statistics(st, invariants["value"], o),
        (stat, orders), {"stat": name, "n": n, "batch": batch})
    return out


def probe_stream_pass(n: int, device: DeviceLike = None) -> ProbeRecord:
    """Measure one elementwise fp32 pass over (n,): ``tune.budget.
    stream_pass``, the pass ``calibrate()`` times; its byte count is the
    probe-backed calibration's rate-constant feature."""
    from repro_torch.tune.budget import stream_pass

    dev = resolve_device(device)
    params = {"n": n}
    return _memoized(
        "tune.stream_pass", dev, params,
        lambda: probe_call("tune.stream_pass", stream_pass,
                           (torch.ones((n,), device=dev),), params))


# --------------------------------------------------------------------------
# Session-level front door
# --------------------------------------------------------------------------
def probe_session(ws, dimensions: int = 10) -> Dict[str, ProbeRecord]:
    """Measure the entry points a ``Workspace`` session runs, at its own
    geometry (``resolved_tiles``), on its device:

    * ``kernels.permute_reduce`` — always (every permutation test), one
      tile of the session's B, S = 1;
    * ``dist.panel_stats``       — feature-backed sessions: one panel of
      the route the production takes (``dist.driver.production_route``);
    * ``kernels.center_matvec``  — square-backed sessions: the square
      operator's matvec is the fused center-matvec in the port (the
      reference probes it when ``matvec_impl="pallas"`` selects it);
    * ``pcoa.fsvd_matfree``      — when the operator hoist is already
      cached (a probe must not trigger builds mid-report).
    """
    tiles = ws.resolved_tiles()
    n, dev = ws.n, ws.device
    records: Dict[str, ProbeRecord] = {}
    records["kernels.permute_reduce"] = probe_permute_reduce(
        n, batch=tiles["batch_size"], s=1,
        chunk=tiles.get("permute_reduce_plain_chunk"), device=dev)
    if ws._features is not None:
        route = tiles["production_route"]
        sparse = {} if route["route"] == "dense" else {
            "nnz": route["nnz"], "max_row": route["max_row"]}
        records["dist.panel_stats"] = probe_panel_stats(
            n, int(ws._features.shape[1]),
            block=tiles["production_panel_rows"], metric=ws._metric.name,
            device=dev, **sparse)
    else:
        records["kernels.center_matvec"] = probe_center_matvec(
            n, k=dimensions, device=dev)
    if "operator" in ws.cache:
        op = ws.cache._store["operator"]      # peek: no counter perturbed
        records["pcoa.fsvd_matfree"] = probe_pcoa_matfree(op, k=dimensions,
                                                          device=dev)
    return records


def probe_table(records: Dict[str, ProbeRecord]) -> List[str]:
    """Aligned text rows for one measured section."""
    rows = []
    for name in sorted(records):
        r = records[name]
        trips = ",".join(f"{k} x{v}" for k, v in r.scan_trips.items()) or "-"
        rows.append(f"{name:28s} {r.backend:4s} {r.flops / 1e6:12.2f} Mflop "
                    f"{r.bytes_corrected / 1e6:12.2f} MB  peak "
                    f"{r.peak_bytes / 1e6:10.2f} MB (args "
                    f"{r.argument_bytes / 1e6:.2f})  launches {trips}")
    return rows
