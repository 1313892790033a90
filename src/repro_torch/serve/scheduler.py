"""TileScheduler: cross-request coalescing of permutation tiles.

The counterpart of ``repro/serve/scheduler.py``. A request for K
permutations is K independent rows of ``(n,)`` orders; the engine
executes rows in padded ``(B, n)`` tiles
(``stats.engine.tile_statistics``). Nothing about a row depends on its
tile-mates — on the card ``permute_reduce`` sums each permutation in an
order fixed by n and its position alone, whatever the other rows of its
tile (``tests/test_torch_cuda.py``), ``within_sums`` (ANOSIM) sums it
exactly (``tests/test_torch_within_sums.py``), and the batched statistics
reduce each row on its own — so the scheduler is free to pack rows from
*different* requests into one tile whenever they share the exact
invariant stack (study, generation, method, operands). Tiles are torch
tensors on the study's device, and B is the service's one
``ServeConfig.batch_size``. That buys:

* **slot reuse** — when a request's last rows retire mid-tile, the next
  tile immediately fills those rows from the queue's next request; chip
  utilization doesn't dip between requests;
* **one signature per statistic shape** — every tile has the same (B, n)
  shape regardless of per-request K (a drained lane pads by cycling the
  rows it did collect), so the sentinel's one-signature-per-(n, S, B)
  invariant of the padded engine extends across the whole mixed-K serve
  run;
* **bitwise determinism** — each request's orders come from its own
  seed or generator via ``engine.permutation_orders`` (identical to what
  a standalone ``Workspace`` run draws), and row independence means its
  p-value is bit-for-bit the same whether it ran alone or coalesced.

Streaming: after each tile the scheduler pushes a ``StreamUpdate`` per
contributing request — running exceedance count, the anytime estimate
``p_partial``, and the *exact envelope* ``[p_lo, p_hi]``: ``p_lo``
assumes every remaining draw misses, ``p_hi`` assumes every remaining
draw exceeds, so ``p_lo`` is monotone nondecreasing, ``p_hi`` monotone
nonincreasing, and the final p-value always lands inside every streamed
interval (they converge to it at the last tile).

Fault tolerance (the recovery half of ``repro_torch.faults``):

* **retry with backoff** — a tile that fails (injected fault, a
  ``RuntimeError`` that is not a device failure, a real out-of-memory, or
  non-finite statistics caught by the output admission check) consumes
  NO cursor state: the lane backs off (cooperatively — ``not_before``
  skips it while other lanes run; bounded exponential delay with
  deterministic jitter) and the SAME rows re-execute on the next
  attempt. The kernels and the plain versions are deterministic, so a
  retried tile reproduces the fault-free values bit-for-bit — which is
  why completed requests under chaos gate bitwise against the fault-free
  run. Retry amplification (re-executed rows) is metered and capped.
* **device failures are not retried** — a kernel that fails to build or
  launch (``kernels._build.KernelError``) or any other CUDA error leaves
  ``step()`` as it is: a CUDA error is sticky, so a retry cannot
  succeed, and a degraded answer would hide the fault.
* **per-lane circuit breaker** — ``breaker_failures`` *consecutive*
  failures (or a blown per-lane retry budget) quarantine the lane:
  every in-flight request degrades to a partial result carrying the
  existing confidence envelope (or a rejection when no draws finished)
  instead of wedging the lane forever on a poison request.
* **cooperative cancellation** — ``cancel()`` terminates one request at
  a tile boundary (per-request deadlines and client aborts), degrading
  it to its current envelope.
* **watchdog escalation** — a tile that began but never completed (the
  step span survives to the next loop turn) is escalated by the
  ``StepMonitor`` heartbeat into the SAME retry path, via the
  structured ``EscalationRecord`` rather than a loop-killing raise.
* **journal** — after every successful tile, each contributing
  request's ``(cursor, count)`` is appended to the crash-safe journal
  (``checkpoint.journal``); counters are append-only, so replaying the
  journal's valid prefix after a crash resumes with completed
  permutation blocks bit-for-bit intact.

Every tile is timed through a ``runtime.monitor.StepMonitor`` span
(phase="step") that ends after the tile's statistics are on the host, so
the straggler/deadline watchdog covers the work and not the launch, and
charged to the study's ``repro_torch.obs`` ledger with the same terms the
library engine uses (``engine.charge_tiles``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.faults import (AllocFault, CompileFault, FaultError,
                                PoisonError, StallFault, TransientTileError,
                                unit_hash)
from repro_torch.kernels._build import KernelError
from repro_torch.runtime.monitor import DeadlineExceeded, StepMonitor
from repro_torch.serve.admission import Rejection
from repro_torch.stats import engine


# --------------------------------------------------------------------------
# Streaming math
# --------------------------------------------------------------------------
def partial_bounds(c: int, draws_done: int, permutations: int) -> dict:
    """Anytime p-value state after ``draws_done`` of K draws with ``c``
    exceedances so far.

    * ``p_partial = (c+1)/(draws_done+1)`` — the estimate *as if* the
      test stopped here (a valid Monte-Carlo p at this draw count);
    * ``p_lo = (c+1)/(K+1)`` — the final p if no remaining draw exceeds
      (monotone nondecreasing in draws_done);
    * ``p_hi = (c + (K - draws_done) + 1)/(K+1)`` — the final p if every
      remaining draw exceeds (monotone nonincreasing).

    The true final p-value lies in ``[p_lo, p_hi]`` for every prefix,
    and both bounds equal it at ``draws_done == K`` — bitwise: all three
    divide in fp32, the same arithmetic ``engine.finish`` performs, so
    the last frame's collapsed envelope IS the final p-value.
    """
    f = np.float32
    k1 = f(permutations + 1)
    return {"p_partial": float(f(c + 1) / f(draws_done + 1)),
            "p_lo": float(f(c + 1) / k1),
            "p_hi": float(f(c + (permutations - draws_done) + 1) / k1)}


def exceedances(observed: float, values: np.ndarray,
                alternative: str) -> int:
    """Null draws at least as extreme as ``observed`` — the numpy twin of
    ``engine.count_better`` (identical comparisons on the same fp32
    values, so incremental serve counts match the engine's one-shot
    count exactly; a NaN observed compares False everywhere, and the
    finisher turns that into a NaN p like ``engine.finish``)."""
    v = np.asarray(values)
    if alternative == "two-sided":
        return int(np.sum(np.abs(v) >= abs(observed)))
    if alternative == "greater":
        return int(np.sum(v >= observed))
    if alternative == "less":
        return int(np.sum(v <= observed))
    raise ValueError(f"unknown alternative {alternative!r}")


@dataclasses.dataclass(frozen=True)
class StreamUpdate:
    """One streamed progress frame for one request (see module docstring
    for the bound semantics)."""

    request_id: str
    method: str
    draws_done: int
    permutations: int
    exceedances: int
    p_partial: float
    p_lo: float
    p_hi: float
    done: bool

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def is_device_failure(exc: BaseException) -> bool:
    """A failure no retry can mend: a kernel that could not be built or
    launched (``KernelError``), or a CUDA error PyTorch reported (sticky
    for the process). A real out-of-memory is not one: freeing memory
    (the pool sheds a session) can mend it."""
    if isinstance(exc, KernelError):
        return True
    if isinstance(exc, torch.OutOfMemoryError):
        return False
    accelerator = getattr(torch, "AcceleratorError", None)
    if accelerator is not None and isinstance(exc, accelerator):
        return True
    return "CUDA error" in str(exc)


# --------------------------------------------------------------------------
# Retry policy
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter, plus the
    circuit-breaker thresholds (see ``ServeConfig`` for the knobs'
    service-level defaults and docs)."""

    base_s: float = 0.01
    multiplier: float = 2.0
    max_backoff_s: float = 0.5
    jitter: float = 0.5
    breaker_failures: int = 3
    budget: int = 64
    seed: int = 0

    def backoff(self, failures: int, label: str, index: int) -> float:
        """Delay before attempt ``failures + 1``. Jitter is a
        deterministic hash of (seed, label, index) — chaos runs replay
        with identical pacing."""
        raw = self.base_s * self.multiplier ** max(failures - 1, 0)
        delay = min(raw, self.max_backoff_s)
        return delay * (1.0 + self.jitter * unit_hash(self.seed, label,
                                                      index))


# --------------------------------------------------------------------------
# Lane keys — "may these requests share a tile?"
# --------------------------------------------------------------------------
def operand_fingerprint(value) -> Optional[tuple]:
    """Hashable identity of a request operand (grouping array etc.):
    dtype + shape + content digest. Two requests coalesce only when
    every operand fingerprint matches — identical invariant stacks."""
    if value is None:
        return None
    arr = (value.detach().cpu().numpy() if isinstance(value, torch.Tensor)
           else np.asarray(value))
    return (arr.dtype.str, arr.shape,
            hashlib.sha1(arr.tobytes()).hexdigest()[:16])


# --------------------------------------------------------------------------
# The scheduler
# --------------------------------------------------------------------------
class _Active:
    """One in-flight request's scheduling state (internal)."""

    __slots__ = ("handle", "orders", "cursor", "count", "observed",
                 "alternative")

    def __init__(self, handle, orders, observed: float, alternative: str):
        self.handle = handle
        self.orders = orders          # (K, n) — this request's own draws
        self.cursor = 0               # rows already executed
        self.count = 0                # running exceedances
        self.observed = observed
        self.alternative = alternative


class Lane:
    """All in-flight requests that share one invariant stack.

    Holds the hoisted ``(stat, invariants, observed)`` built once at
    lane creation and a FIFO of ``_Active`` requests. ``next_tile``
    assembles the next (B, n) tile: rows come from the front request
    until it drains, then the next (slot reuse); a short final tile pads
    by cycling the rows it did collect — real permutations, so the tile
    shape (and with it every kernel's launch geometry) never changes, and
    the padded rows are simply not attributed to any request.

    Fault state: ``failures`` counts *consecutive* failed tile attempts
    (reset on success — the breaker trips at ``breaker_failures``),
    ``retries`` the lane-lifetime total (capped by the retry budget),
    ``not_before`` the monotonic instant before which the lane is
    backing off (the step loop skips it, cooperatively).
    """

    def __init__(self, key, ws, stat, invariants, observed: float,
                 batch_size: int):
        self.key = key
        self.ws = ws
        self.stat = stat
        self.invariants = invariants
        self.observed = observed
        self.batch_size = int(batch_size)
        self.requests: list = []
        self.tiles_run = 0
        self.failures = 0             # consecutive failed attempts
        self.retries = 0              # lane-lifetime failed attempts
        self.not_before = 0.0         # monotonic backoff gate

    def pending_rows(self) -> int:
        return sum(a.orders.shape[0] - a.cursor for a in self.requests)

    def next_tile(self):
        """``(tile, parts)``: the (B, n) orders tile plus
        ``[(active, take), ...]`` attributing its leading rows."""
        b = self.batch_size
        parts, chunks, have = [], [], 0
        for a in self.requests:
            if have == b:
                break
            take = min(b - have, a.orders.shape[0] - a.cursor)
            if take:
                chunks.append(a.orders[a.cursor:a.cursor + take])
                parts.append((a, take))
                have += take
        if have < b:                      # drained: pad by cycling rows
            real = torch.cat(chunks) if len(chunks) > 1 else chunks[0]
            chunks.append(real[torch.arange(b - have,
                                            device=real.device) % have])
        tile = torch.cat(chunks) if len(chunks) > 1 else chunks[0]
        return tile, parts


class TileScheduler:
    """Round-robin tile executor over coalescing lanes.

    ``submit`` binds a request to its lane (creating the lane — one
    hoist via ``engine.hoist_and_observe`` — when it is the first);
    ``step`` executes ONE tile from the next lane with pending rows,
    streams updates, finishes retired requests. The service drives
    ``step`` in its event loop; a stalled tile (open step span at the
    loop head) is escalated by the watchdog into the retry path.

    ``injector`` (``repro_torch.faults.FaultInjector`` or None) arms the
    ``serve.tile`` injection site; ``retry`` is the backoff/breaker
    policy; ``journal`` (``checkpoint.Journal`` or None) receives
    per-request progress records after each tile; ``on_oom`` is the
    service's allocator-pressure hook (shed pool bytes before retry).
    """

    def __init__(self, batch_size: int = 32,
                 monitor: Optional[StepMonitor] = None, metrics=None,
                 injector=None, retry: Optional[RetryPolicy] = None,
                 journal=None, on_oom=None):
        self.batch_size = int(batch_size)
        self.monitor = monitor if monitor is not None else StepMonitor()
        self.metrics = metrics
        self.injector = injector
        self.retry = retry if retry is not None else RetryPolicy()
        self.journal = journal
        self.on_oom = on_oom
        self.lanes: "OrderedDict[tuple, Lane]" = OrderedDict()
        self.tiles_run = 0
        self._step_counter = 0
        self._stalled_lane: Optional[Lane] = None

    # -- submission --------------------------------------------------------
    def submit(self, handle, ws, lane_key, stat, default_alternative: str
               ) -> None:
        """Activate one admitted request on its lane. Raises
        ``CompileFault`` when the ``serve.hoist`` injection site fires
        at lane creation (the service retries activation)."""
        lane = self.lanes.get(lane_key)
        if lane is None:
            if self.injector is not None:
                for spec in self.injector.poll("serve.hoist"):
                    if spec.kind == "compile":
                        if self.metrics is not None:
                            self.metrics.record_fault("serve.hoist",
                                                      "compile")
                        raise CompileFault(
                            f"injected hoist/compile failure for lane "
                            f"{lane_key[2]}")
            b = ws.config.resolve_batch_size(None, self.batch_size)
            with ws.obs.span("serve.hoist_lane", phase="serve",
                             method=handle.method, n=stat.n,
                             batch_size=b):
                invariants, observed = engine.hoist_and_observe(stat,
                                                                ws.device)
            lane = Lane(lane_key, ws, stat, invariants, float(observed),
                        b)
            self.lanes[lane_key] = lane
        orders = engine.permutation_orders(
            handle.key, handle.permutations, stat.n, ws.device)
        alt = handle.alternative or default_alternative
        active = _Active(handle, orders, lane.observed, alt)
        k = int(orders.shape[0])
        resume = int(getattr(handle, "resume_cursor", 0) or 0)
        if resume:
            # journal recovery: completed permutation blocks are NOT
            # re-run — the append-only (cursor, count) state restores
            # bit-for-bit and execution continues at the cursor
            active.cursor = min(resume, k)
            active.count = int(getattr(handle, "resume_count", 0) or 0)
            if self.metrics is not None:
                self.metrics.record_resume(active.cursor)
        handle.status = "active"
        handle.statistic = lane.observed
        if active.cursor >= k:
            # the crash landed between the last progress record and the
            # terminal record: every draw is already done — finish now
            self._emit(active)
            if not lane.requests and not lane.pending_rows():
                del self.lanes[lane_key]
            return
        lane.requests.append(active)

    # -- execution ---------------------------------------------------------
    def has_work(self) -> bool:
        return any(lane.pending_rows() for lane in self.lanes.values())

    def active_studies(self) -> set:
        """Study ids with in-flight rows — the pool's eviction pin set."""
        return {lane.key[0] for lane in self.lanes.values()
                if lane.pending_rows()}

    def step(self) -> bool:
        """Execute one tile; returns False when no lane had work.

        A failed tile (fault, non-finite output) consumes nothing: the
        lane backs off and the SAME rows retry. A stalled tile from the
        previous turn is escalated here, first. A device failure (a kernel
        that cannot build or launch, any CUDA error) is raised, not
        retried."""
        if self._consume_stall():
            return True
        now = time.monotonic()
        lane = next((ln for ln in self.lanes.values()
                     if ln.pending_rows() and ln.not_before <= now), None)
        if lane is None:
            waits = [ln.not_before - now for ln in self.lanes.values()
                     if ln.pending_rows()]
            if waits:                     # all backing off: wait it out
                time.sleep(min(min(waits), 0.05))
                return True
            return False
        # round-robin: the lane we serve moves to the back
        self.lanes.move_to_end(lane.key)
        tile, parts = lane.next_tile()
        b = tile.shape[0]
        self._step_counter += 1
        self.monitor.start()
        try:
            values = self._execute(lane, tile)
        except StallFault:
            # the tile "never returns": leave the step span OPEN so the
            # next loop turn's watchdog heartbeat escalates it — the
            # regression the monitor's escalate() path exists for
            self._stalled_lane = lane
            if self.metrics is not None:
                self.metrics.record_tile_failure("stall", b)
            return True
        except (FaultError, RuntimeError) as e:
            self.monitor.abort(reason=str(e))
            if is_device_failure(e):
                raise
            self._tile_failure(lane, b, e)
            return True
        step_rec = self.monitor.stop(self._step_counter)
        lane.failures = 0                 # consecutive window resets
        lane.tiles_run += 1
        self.tiles_run += 1
        # the padded tail rows are real gathers — charged like the
        # engine charges its own padded tiles
        engine.charge_tiles(lane.ws.obs,
                            f"serve:{parts[0][0].handle.method}",
                            lane.stat, lane.ws.device, b, b)
        if self.metrics is not None:
            self.metrics.record_tile(b, len(parts),
                                     seconds=step_rec.seconds)
        offset = 0
        for active, take in parts:
            rows = values[offset:offset + take]
            offset += take
            active.count += exceedances(active.observed, rows,
                                        active.alternative)
            active.cursor += take
            self._journal_progress(active)
            self._emit(active)
        for active, _ in parts:
            if active.cursor >= active.orders.shape[0]:
                lane.requests.remove(active)
        if not lane.pending_rows() and not lane.requests:
            del self.lanes[lane.key]
        return True

    # -- tile execution + fault injection ----------------------------------
    def _execute(self, lane: Lane, tile) -> np.ndarray:
        """One tile through the engine, with the ``serve.tile``
        injection site armed and the non-finite output admission check
        (injected or real NaN statistics take the retry path instead of
        silently skewing exceedance counts). The statistics come back to
        the host here, inside the tile's step span."""
        specs = (self.injector.poll("serve.tile")
                 if self.injector is not None else ())
        poison_rows = None
        for spec in specs:
            if self.metrics is not None:
                self.metrics.record_fault("serve.tile", spec.kind)
            if spec.kind == "slow":
                time.sleep(spec.delay_s)          # completes, but late
            elif spec.kind == "stall":
                if spec.delay_s:
                    time.sleep(spec.delay_s)
                raise StallFault("injected stalled tile")
            elif spec.kind == "error":
                raise TransientTileError("injected transient tile error")
            elif spec.kind == "oom":
                raise AllocFault("injected allocator OOM on tile")
            elif spec.kind == "nan":
                poison_rows = spec
        values = engine.tile_statistics(lane.stat, lane.invariants,
                                        tile).cpu().numpy()
        if poison_rows is not None:
            values = values.copy()
            values[:] = np.nan
        if not np.all(np.isfinite(values)):
            raise PoisonError(
                f"tile returned non-finite statistics "
                f"({int(np.sum(~np.isfinite(values)))}/{values.size} rows)")
        return values

    def _fault_kind(self, exc: Exception) -> str:
        if isinstance(exc, (AllocFault, torch.OutOfMemoryError)):
            return "oom"
        if isinstance(exc, PoisonError):
            return "poison"
        if isinstance(exc, TransientTileError):
            return "transient"
        if isinstance(exc, StallFault):
            return "stall"
        return "runtime"

    def _tile_failure(self, lane: Lane, rows: int, exc: Exception) -> None:
        """The shared retry path: back off and re-attempt, or trip the
        breaker. Cursor state was NOT advanced, so the retried tile
        re-executes the identical rows (bitwise-neutral)."""
        kind = self._fault_kind(exc)
        lane.failures += 1
        lane.retries += 1
        if self.metrics is not None:
            self.metrics.record_tile_failure(kind, rows)
        if kind == "oom" and self.on_oom is not None:
            self.on_oom(lane)
        over_breaker = lane.failures >= self.retry.breaker_failures
        over_budget = lane.retries > self.retry.budget
        if over_breaker or over_budget:
            why = ("circuit breaker opened after "
                   f"{lane.failures} consecutive tile failures"
                   if over_breaker else
                   f"lane retry budget exhausted ({lane.retries} > "
                   f"{self.retry.budget})")
            self.quarantine(lane, Rejection(
                "circuit_open",
                f"{why}; last failure: {exc}",
                {"method": lane.key[2], "failures": lane.failures,
                 "retries": lane.retries, "kind": kind}))
            return
        delay = self.retry.backoff(lane.failures, f"backoff:{lane.key[2]}",
                                   lane.retries)
        lane.not_before = time.monotonic() + delay
        if self.metrics is not None:
            self.metrics.record_retry(rows, delay)

    def _consume_stall(self) -> bool:
        """Escalate a tile that began last turn but never completed.

        The heartbeat path is tried first: past the straggler deadline
        it raises ``DeadlineExceeded`` carrying the structured
        ``EscalationRecord``. Before any median exists (deadline = inf)
        the stall is escalated unconditionally — a first-tile stall
        must not hang the loop. Either way the record feeds the same
        retry path as any other tile failure."""
        if self.monitor._open is None:
            return False
        try:
            self.monitor.heartbeat()
            # under-deadline (or pre-median) but the span is open at the
            # loop head — in this single-threaded loop that can only
            # mean the previous tile never completed: escalate anyway,
            # a watchdog that cannot fire before warmup would let a
            # first-tile stall hang the service
            record = self.monitor.escalate("stalled tile detected at "
                                           "step head")
        except DeadlineExceeded as e:
            record = e.record
            self.monitor.abort(reason=record.reason)
        lane = self._stalled_lane
        self._stalled_lane = None
        if self.metrics is not None:
            self.metrics.record_escalation()
        if lane is not None:
            self._tile_failure(
                lane, lane.batch_size,
                TransientTileError(
                    f"watchdog escalation: {record.reason} "
                    f"(elapsed {record.elapsed_s:.3f}s, deadline "
                    f"{record.deadline_s:.3f}s)"))
        return True

    # -- quarantine / cancellation / invalidation --------------------------
    def _terminate(self, active: _Active, rejection: Rejection,
                   degrade_ok: bool = True) -> None:
        """Terminal state for one in-flight request: a degraded partial
        result when any draws completed (the streamed envelope IS the
        deliverable), a rejection otherwise."""
        handle = active.handle
        k = int(active.orders.shape[0])
        if degrade_ok and active.cursor > 0:
            handle.degrade(rejection,
                           draws_done=active.cursor, count=active.count,
                           permutations=k)
        else:
            handle.reject(rejection)

    def quarantine(self, lane: Lane, rejection: Rejection) -> None:
        """Open the lane's breaker: degrade/reject every request, drop
        the lane. The lane's hoists (owned by the Workspace cache) stay
        resident — quarantine isolates the poison *request stack*, not
        the study."""
        if self.metrics is not None:
            self.metrics.record_breaker()
        for active in list(lane.requests):
            self._terminate(active, rejection)
        lane.requests.clear()
        self.lanes.pop(lane.key, None)

    def cancel(self, handle, rejection: Rejection) -> bool:
        """Cooperatively cancel one in-flight request at a tile
        boundary (deadline lapse or client abort): it terminates as a
        degraded partial (draws so far) or a rejection."""
        for lane in list(self.lanes.values()):
            for active in lane.requests:
                if active.handle is handle:
                    self._terminate(active, rejection)
                    lane.requests.remove(active)
                    if not lane.requests:
                        self.lanes.pop(lane.key, None)
                    if self.metrics is not None:
                        self.metrics.record_cancel(rejection.code)
                    return True
        return False

    def invalidate_study(self, study_id: str,
                         keep_generation: Optional[int] = None) -> int:
        """Terminate every in-flight request bound to ``study_id`` at a
        generation other than ``keep_generation`` (None = all): the
        eviction/re-upload race. The data a stale lane hoisted no
        longer exists as far as the client is concerned, so in-flight
        requests terminate with a structured ``stale_generation``
        rejection — never a crash, and never a result computed against
        data the client just replaced. Returns the request count."""

        def stale(key) -> bool:
            if key[0] == study_id and (keep_generation is None
                                       or key[1] != keep_generation):
                return True
            for op in key[3]:
                # Mantel-family operands carry (study_id, generation)
                if (isinstance(op, tuple) and len(op) == 2
                        and op[0] == study_id
                        and (keep_generation is None
                             or op[1] != keep_generation)):
                    return True
            return False

        terminated = 0
        for key, lane in list(self.lanes.items()):
            if not stale(key):
                continue
            for active in list(lane.requests):
                self._terminate(active, Rejection(
                    "stale_generation",
                    f"study {study_id!r} was re-uploaded or evicted while "
                    f"this request was in flight; its hoisted data is "
                    f"stale — resubmit against the current generation",
                    {"study_id": study_id,
                     "lane_generation": key[1],
                     "request_id": active.handle.request_id}),
                    degrade_ok=False)
                terminated += 1
                if self.metrics is not None:
                    self.metrics.record_stale()
            lane.requests.clear()
            self.lanes.pop(key, None)
        return terminated

    # -- streaming / journaling --------------------------------------------
    def _journal_progress(self, active: _Active) -> None:
        if self.journal is not None:
            self.journal.append({"t": "progress",
                                 "rid": active.handle.request_id,
                                 "cursor": int(active.cursor),
                                 "count": int(active.count)})

    def _emit(self, active: _Active) -> None:
        k = int(active.orders.shape[0])
        done = active.cursor >= k
        bounds = partial_bounds(active.count, active.cursor, k)
        update = StreamUpdate(
            request_id=active.handle.request_id,
            method=active.handle.method,
            draws_done=active.cursor, permutations=k,
            exceedances=active.count, done=done, **bounds)
        active.handle.push_update(update)
        if done:
            # identical finishing rule to engine.finish, down to the
            # fp32 division: +1 correction, NaN observed -> NaN p
            p = np.float32(active.count + 1) / np.float32(k + 1)
            key = active.handle.key
            active.handle.complete(engine.PermutationTestResult(
                active.observed,
                float("nan") if np.isnan(active.observed) else float(p),
                active.orders.shape[1], k, active.handle.method,
                key if isinstance(key, int) else None))
