"""AnalysisService: the multi-tenant front door over the analysis stack.

The counterpart of ``repro/serve/service.py``.

One object ties the subsystem together: uploads admit studies into the
``SessionPool`` (validation + ``ExecConfig(auto=True)`` tune-solve at
admission), submissions enter the bounded ``RequestQueue``, and the
event loop (``step`` / ``run`` / ``arun``) activates queued requests up
to a concurrency bound and pumps the ``TileScheduler`` one coalesced
tile at a time. Clients hold a ``RequestHandle``: streamed
``StreamUpdate`` frames while tiles complete, then the final
``PermutationTestResult`` (or an ``OrdinationResult`` for ``pcoa``,
served synchronously off the pooled session's coordinate cache), or a
structured ``Rejection`` — never a traceback.

The service runs on the card unless ``ServeConfig.device`` asks for the
CPU (and raises when there is no card and the CPU was not asked for);
every pooled session, tile and hoist lives on that device. It is
cooperative and single-threaded by design (tiles are the natural quantum,
and each tile's statistics come back to the host before the next is
assembled): ``arun`` is an asyncio driver that yields between tiles so
many client coroutines can await their handles concurrently.

Keys: a request's ``key`` is an int seed (``None`` is seed 0, as in
``engine.permutation_test``) or a CPU ``torch.Generator``. A generator's
state is copied at submit, so the request draws the same orders whenever
it is activated, and the journal records an int as itself and a
generator as its ``get_state()`` bytes; ``recover`` rebuilds it with
``set_state``, so a replayed request draws the same orders.

Fault tolerance: the service owns the assembled recovery plane. A
``ServeConfig.fault_plan`` (``repro_torch.faults.FaultPlan``) arms the
deterministic injector at the three serve sites — tiles
(``serve.tile``, handled by the scheduler's retry/breaker path), lane
hoists (``serve.hoist``, retried at activation, ``unavailable`` when
exhausted), and the pool (``serve.pool``, a forced mid-flight eviction
whose in-flight requests terminate with ``stale_generation``). Per-
request deadlines follow a request from the queue *through execution*
(cooperative cancellation at tile boundaries, degrading to the partial
envelope); an injected/real allocator OOM sheds an idle pooled session
before the retry. With ``journal_path`` set, every submission, per-tile
progress record, and terminal state lands in a crash-safe append-only
journal (``checkpoint.journal``), and ``AnalysisService.recover``
rebuilds a service from the journal's valid prefix against a surviving
pool: completed permutation blocks are NOT re-run and nothing re-hoists,
so recovered requests finish with bitwise-identical p-values.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.api.config import ExecConfig
from repro_torch.checkpoint.journal import Journal
from repro_torch.checkpoint.journal import replay as journal_replay
from repro_torch.core.distance_matrix import MAX_TRIANGLE_N
from repro_torch.faults import CompileFault, FaultInjector, FaultPlan
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.obs.config import ObsConfig
from repro_torch.serve.admission import (Rejected, Rejection, RequestQueue,
                                         validate_upload)
from repro_torch.serve.metrics import ServeMetrics, serve_report
from repro_torch.serve.pool import SessionPool
from repro_torch.serve.scheduler import (RetryPolicy, StreamUpdate,
                                         TileScheduler, operand_fingerprint,
                                         partial_bounds)

#: the analyses the front door serves — the Workspace battery, complete
METHODS = ("pcoa", "permanova", "anosim", "permdisp", "mantel",
           "partial_mantel")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Service knobs (all bounded-by-default: a front door that cannot
    say no is a memory leak with an API).

    ``batch_size`` is the coalesced tile's B — the same quantity as
    ``ExecConfig.batch_size``, fixed service-wide so every study's tiles
    share program shapes. ``max_active`` bounds concurrently-scheduled
    requests (the rest wait in the admission queue, where ``timeout_s``
    deadlines and ``max_queue`` backpressure apply — and the deadline
    keeps following the request through execution: an active request
    past it is cooperatively cancelled at the next tile boundary,
    degrading to its partial envelope). ``auto_tune`` runs the
    ``repro_torch.tune`` solver at upload against each study's own (n, d).
    ``deadline_factor`` parameterizes the tile watchdog
    (``runtime.monitor.StepMonitor``). ``device`` is where every pooled
    session, tile and hoist lives: ``None`` (default) the card, ``"cpu"``
    the CPU (the plain versions).

    The ``slo_*_s`` thresholds (all optional) arm the latency SLOs:
    queue wait (submit → activation), tile execution, and end-to-end
    request latency samples past a threshold tick the matching breach
    counter in ``serve_report()["slo"]`` — the alerting hook a fleet
    dashboard scrapes (``ServeMetrics.prometheus()``) without the
    service ever failing a request over a slow tile.

    Fault/recovery knobs: ``retry_*`` shape the bounded exponential
    backoff for failed tiles (deterministic jitter — replayable);
    ``breaker_failures`` consecutive failures (or ``retry_budget``
    lifetime failures) open a lane's circuit breaker, degrading its
    requests instead of retrying forever; ``fault_plan`` arms the
    deterministic injector (None = every injection point compiles to an
    ``is None`` check — zero-cost when disabled); ``journal_path``
    enables the crash-safe progress journal (``journal_fsync`` trades
    throughput for durability-per-record).

    The defaults are the reference's."""

    batch_size: int = 32
    max_sessions: int = 8
    max_bytes: Optional[int] = None
    max_queue: int = 64
    max_active: int = 8
    max_n: int = MAX_TRIANGLE_N
    timeout_s: Optional[float] = 30.0
    auto_tune: bool = True
    observe: bool = True
    deadline_factor: float = 20.0
    slo_queue_wait_s: Optional[float] = None
    slo_tile_s: Optional[float] = None
    slo_request_s: Optional[float] = None
    retry_base_s: float = 0.01
    retry_multiplier: float = 2.0
    retry_max_backoff_s: float = 0.5
    retry_jitter: float = 0.5
    breaker_failures: int = 3
    retry_budget: int = 64
    fault_plan: Optional[FaultPlan] = None
    journal_path: Optional[str] = None
    journal_fsync: bool = False
    device: Optional[str] = None


class RequestHandle:
    """A client's view of one request: status, streamed updates, result.

    ``status`` walks queued → active → done (or degraded / rejected /
    timed_out — ``degraded`` means the service terminated the request
    early but *some* draws completed, so the final streamed frame's
    ``[p_lo, p_hi]`` envelope is a valid partial answer). ``updates``
    accumulates ``StreamUpdate`` frames; ``result`` is the final
    ``PermutationTestResult`` / ``OrdinationResult``; ``error`` the
    ``Rejection``. ``payload()`` is the wire-shaped response — one
    uniform shape for every terminal state.
    """

    def __init__(self, request_id: str, study_id: str, method: str,
                 permutations: int, key, alternative: Optional[str],
                 params: dict):
        self.request_id = request_id
        self.study_id = study_id
        self.method = method
        self.permutations = permutations
        self.key = key
        self.alternative = alternative
        self.params = params
        self.status = "queued"
        self.updates: list = []
        self.result = None
        self.error: Optional[Rejection] = None
        self.statistic: Optional[float] = None
        self.deadline: Optional[float] = None
        self.resume_cursor = 0        # journal recovery: draws already done
        self.resume_count = 0         # ... and exceedances among them
        self.t_submit = time.perf_counter()
        self.t_active: Optional[float] = None     # left the queue
        self.t_done: Optional[float] = None

    # -- scheduler callbacks ----------------------------------------------
    def push_update(self, update) -> None:
        self.updates.append(update)

    def complete(self, result) -> None:
        self.result = result
        self.status = "done"
        self.t_done = time.perf_counter()

    def reject(self, rejection: Rejection) -> None:
        self.error = rejection
        self.status = ("timed_out" if rejection.code in ("timeout",
                                                         "deadline")
                       else "rejected")
        self.t_done = time.perf_counter()

    def degrade(self, rejection: Rejection, *, draws_done: int,
                count: int, permutations: int) -> None:
        """Terminate early WITH a partial answer: a final frame whose
        envelope ``[p_lo, p_hi]`` brackets the p-value the request would
        have finished with (circuit breaker, cancellation, deadline)."""
        bounds = partial_bounds(count, draws_done, permutations)
        self.updates.append(StreamUpdate(
            request_id=self.request_id, method=self.method,
            draws_done=draws_done, permutations=permutations,
            exceedances=count, done=False, **bounds))
        self.error = rejection
        self.status = "degraded"
        self.t_done = time.perf_counter()

    # -- client surface ----------------------------------------------------
    @property
    def done(self) -> bool:
        return self.status in ("done", "degraded", "rejected", "timed_out")

    def partial(self):
        """The latest streamed frame (None before the first tile)."""
        return self.updates[-1] if self.updates else None

    def payload(self) -> dict:
        """The wire-shaped response for the request's current state.

        One uniform shape regardless of outcome: ``status`` is always
        present; ``error`` is the structured rejection or None;
        ``progress`` is the latest streamed frame (which for permutation
        methods carries the partial-bounds fields ``p_partial`` /
        ``p_lo`` / ``p_hi`` — for a degraded request this IS the
        deliverable) or None; ``result`` the final result or None.
        Callers branch on ``status``/``error`` — never on which keys
        exist."""
        p = self.partial()
        out = {"request_id": self.request_id, "study_id": self.study_id,
               "method": self.method, "status": self.status,
               "error": (self.error.payload()["error"]
                         if self.error is not None else None),
               "progress": p.to_dict() if p is not None else None,
               "result": None}
        if self.result is not None:
            if self.method == "pcoa":
                out["result"] = {
                    "dimensions": int(self.result.coordinates.shape[1]),
                    "proportion_explained":
                        [float(v) for v in self.result.proportion_explained],
                }
            else:
                out["result"] = {
                    "statistic": self.result.statistic,
                    "p_value": self.result.p_value,
                    "permutations": self.result.permutations,
                    "sample_size": self.result.sample_size,
                }
        return out


def _request_key(key):
    """A request's key: an int seed (``None`` is seed 0), or a copy of a
    CPU generator's state taken now, so the request's orders do not
    depend on when it is activated or on later draws from the caller's
    generator."""
    if key is None:
        return 0
    if isinstance(key, torch.Generator):
        if key.device.type != "cpu":
            raise ValueError("a request key must be an int seed or a CPU "
                             f"torch.Generator, got one on {key.device}")
        copy = torch.Generator()
        copy.set_state(key.get_state())
        return copy
    return int(key)


def _key_data(key):
    """A request key in the journal's wire form: an int seed as itself, a
    generator as the hex of its ``get_state()`` bytes."""
    if isinstance(key, torch.Generator):
        return {"generator": bytes(key.get_state().tolist()).hex()}
    return int(key)


def _key_from_data(data):
    """The key ``_key_data`` journaled."""
    if isinstance(data, dict):
        gen = torch.Generator()
        gen.set_state(torch.tensor(list(bytes.fromhex(data["generator"])),
                                   dtype=torch.uint8))
        return gen
    return int(data)


class AnalysisService:
    """The front door (see module docstring).

    ``pool`` lets a rebuilt service adopt a surviving ``SessionPool``
    (the journal-recovery path: sessions — and their hoists — outlive
    the front-door state that crashed)."""

    def __init__(self, config: Optional[ServeConfig] = None,
                 pool: Optional[SessionPool] = None):
        self.config = config if config is not None else ServeConfig()
        self.device = resolve_device(self.config.device)
        self.pool = pool if pool is not None else SessionPool(
            self.config.max_sessions, self.config.max_bytes)
        self.queue = RequestQueue(self.config.max_queue)
        self.metrics = ServeMetrics(slo={
            "queue_wait": self.config.slo_queue_wait_s,
            "tile": self.config.slo_tile_s,
            "request": self.config.slo_request_s})
        plan = self.config.fault_plan
        self.injector = FaultInjector(plan) if plan is not None else None
        self.journal = (Journal(self.config.journal_path,
                                fsync=self.config.journal_fsync)
                        if self.config.journal_path else None)
        retry = RetryPolicy(
            base_s=self.config.retry_base_s,
            multiplier=self.config.retry_multiplier,
            max_backoff_s=self.config.retry_max_backoff_s,
            jitter=self.config.retry_jitter,
            breaker_failures=self.config.breaker_failures,
            budget=self.config.retry_budget,
            seed=plan.seed if plan is not None else 0)
        self.scheduler = TileScheduler(
            batch_size=self.config.batch_size, metrics=self.metrics,
            injector=self.injector, retry=retry, journal=self.journal,
            on_oom=self._shed)
        self.scheduler.monitor.deadline_factor = self.config.deadline_factor
        self._active: list = []
        self._ids = itertools.count(1)
        self._exec_config = ExecConfig(
            batch_size=self.config.batch_size,
            auto=self.config.auto_tune,
            obs=ObsConfig(enabled=self.config.observe),
            device=self.config.device)

    # -- uploads -----------------------------------------------------------
    def upload(self, study_id: str, data=None, *, features=None,
               metric=None) -> dict:
        """Admit (or re-admit) one study; returns the admission ack.

        Validation happens before any O(n²) work (structured rejection
        payloads for non-finite/oversized/misshapen uploads); admission
        builds the pooled ``Workspace`` — which resolves
        ``ExecConfig(auto=True)`` against this study's own (n, d) — and
        re-upload of a known id routes through ``Workspace.refresh``:
        the generation bumps, every cached hoist drops, and any request
        *mid-flight against the old generation* is terminated with a
        structured ``stale_generation`` rejection — its hoisted data no
        longer matches what the client believes is uploaded, so
        finishing it would silently answer about replaced data.
        """
        t0 = time.perf_counter()
        try:
            kind, n = validate_upload(data, features,
                                      max_n=self.config.max_n)
        except Rejected as e:
            self.metrics.record_rejection(e.rejection.code)
            raise
        resident = study_id in self.pool
        try:
            ws = self.pool.admit(
                study_id, self._exec_config,
                dm=data if kind == "dm" else None,
                features=features if kind == "features" else None,
                metric=metric)
        except ValueError as e:
            # the Workspace's own admission checks (asymmetry, non-hollow
            # diagonal, ...) — still a structured refusal, not a traceback
            self.metrics.record_rejection("bad_request")
            raise Rejected(Rejection("bad_request", str(e),
                                     {"study_id": study_id})) from None
        if resident:
            # the re-upload race: lanes hoisted against the old
            # generation are stale the moment refresh() returns
            self.scheduler.invalidate_study(
                study_id, keep_generation=ws.generation)
        self.metrics.record_upload(study_id, n,
                                   time.perf_counter() - t0)
        return {"study_id": study_id, "n": ws.n,
                "generation": ws.generation,
                "backing": kind,
                "cache_nbytes": ws.cache.nbytes(),
                "tuned": ws.tuned is not None}

    # -- submissions -------------------------------------------------------
    def submit(self, study_id: str, method: str, *, grouping=None,
               other=None, control=None, permutations: int = 999,
               key=None, alternative: Optional[str] = None,
               dimensions: Optional[int] = None, pcoa_method: str = "fsvd",
               timeout_s: Optional[float] = None) -> RequestHandle:
        """Enqueue one analysis request; returns its handle immediately.

        ``other``/``control`` name *uploaded studies* (the Mantel-family
        operands live server-side, like the permuted side). The request
        waits in the bounded queue until the loop activates it;
        ``queue_full`` raises ``Rejected`` immediately, a lapsed
        ``timeout_s`` fails the handle with a ``timeout`` rejection
        while queued or cancels it cooperatively once active.
        """
        if method not in METHODS:
            self.metrics.record_rejection("bad_request")
            raise Rejected.make(
                "bad_request",
                f"unknown method {method!r}; available: {list(METHODS)}",
                method=method)
        if study_id not in self.pool:
            self.metrics.record_rejection("unknown_study")
            raise Rejected.make(
                "unknown_study",
                f"study {study_id!r} is not resident (never uploaded, or "
                f"evicted) — upload it first", study_id=study_id)
        try:
            key = _request_key(key)
        except (TypeError, ValueError) as e:
            self.metrics.record_rejection("bad_request")
            raise Rejected.make("bad_request", str(e)) from None
        handle = RequestHandle(
            request_id=f"r{next(self._ids)}", study_id=study_id,
            method=method, permutations=int(permutations),
            key=key, alternative=alternative,
            params={"grouping": grouping, "other": other,
                    "control": control, "dimensions": dimensions,
                    "pcoa_method": pcoa_method})
        try:
            self.queue.push(handle, timeout_s if timeout_s is not None
                            else self.config.timeout_s)
        except Rejected as e:
            self.metrics.record_rejection(e.rejection.code)
            handle.reject(e.rejection)
            return handle
        self._journal_submit(handle)
        self.metrics.record_admission()
        self.metrics.sample_queue_depth(len(self.queue))
        return handle

    def cancel(self, handle: RequestHandle) -> bool:
        """Client abort: terminate one request wherever it is. A queued
        request rejects (``cancelled``); an active one cancels
        cooperatively at the tile boundary, degrading to its partial
        envelope when any draws completed. Returns False when the
        request already terminated."""
        if handle.done:
            return False
        rej = Rejection("cancelled", "request cancelled by client",
                        {"request_id": handle.request_id})
        if handle.status == "queued":
            try:
                self.queue._q.remove(handle)
            except ValueError:
                pass
            handle.reject(rej)
            self.metrics.record_cancel("cancelled")
            return True
        return self.scheduler.cancel(handle, rej)

    # -- activation --------------------------------------------------------
    def _lane_key(self, ws, handle) -> tuple:
        """Requests may share a tile iff this matches: same study at the
        same generation, same method, same operand identities (grouping
        content; Mantel operand studies at their own generations; the
        ordination geometry behind permdisp)."""
        p = handle.params
        operands = [operand_fingerprint(p["grouping"])]
        for name in ("other", "control"):
            sid = p[name]
            if sid is not None:
                ref = self.pool.get(sid)
                operands.append((sid, ref.generation if ref else None))
            else:
                operands.append(None)
        operands.append((p["dimensions"], p["pcoa_method"])
                        if handle.method == "permdisp" else None)
        return (handle.study_id, ws.generation, handle.method,
                tuple(operands))

    def _activate(self, handle) -> None:
        """Bind one queued request to the scheduler (or finish it on the
        spot for ``pcoa``). Statistic-construction failures — bad
        grouping length, mismatched operand sizes, collinear partial-
        Mantel controls — become ``bad_request`` rejections; a lane
        hoist/compile failure retries, then ``unavailable``."""
        handle.t_active = time.perf_counter()
        self.metrics.record_queue_wait(handle.t_active - handle.t_submit)
        ws = self.pool.get(handle.study_id)
        if ws is None:                        # evicted while queued
            handle.reject(Rejection(
                "unknown_study",
                f"study {handle.study_id!r} was evicted while the "
                f"request waited; re-upload and retry",
                {"study_id": handle.study_id}))
            self.metrics.record_rejection("unknown_study")
            return
        p = handle.params
        try:
            if handle.method == "pcoa":
                dims = p["dimensions"] if p["dimensions"] is not None else 10
                result = ws.pcoa(dimensions=dims, method=p["pcoa_method"],
                                 key=handle.key)
                handle.complete(result)
                self._finish(handle)
                return
            kwargs = {}
            if handle.method in ("permanova", "anosim", "permdisp"):
                kwargs["grouping"] = p["grouping"]
            if handle.method == "permdisp":
                kwargs["dimensions"] = p["dimensions"]
                kwargs["pcoa_method"] = p["pcoa_method"]
            if handle.method in ("mantel", "partial_mantel"):
                kwargs["other"] = self._resolve_operand(p["other"], "other")
            if handle.method == "partial_mantel":
                kwargs["control"] = self._resolve_operand(p["control"],
                                                          "control")
            stat, default_alt = ws.statistic(handle.method, **kwargs)
            lane_key = self._lane_key(ws, handle)
            attempts = 0
            while True:
                try:
                    self.scheduler.submit(handle, ws, lane_key, stat,
                                          default_alt)
                    break
                except CompileFault as e:
                    # transient hoist/compile failure: retry the
                    # activation in place (the lane was never created,
                    # so nothing to unwind), give up as `unavailable`
                    attempts += 1
                    if attempts >= max(2, self.config.breaker_failures):
                        handle.reject(Rejection(
                            "unavailable",
                            f"lane compilation failed "
                            f"{attempts} times: {e}",
                            {"method": handle.method,
                             "attempts": attempts}))
                        self.metrics.record_rejection("unavailable")
                        return
            self._active.append(handle)
        except Rejected as e:
            handle.reject(e.rejection)
            self.metrics.record_rejection(e.rejection.code)
        except (ValueError, TypeError) as e:
            rej = Rejection("bad_request", str(e),
                            {"method": handle.method})
            handle.reject(rej)
            self.metrics.record_rejection("bad_request")

    def _resolve_operand(self, sid, role: str):
        if sid is None:
            raise Rejected.make("bad_request",
                                f"this method requires {role}= naming an "
                                f"uploaded study")
        ws = self.pool.get(sid)
        if ws is None:
            raise Rejected.make("unknown_study",
                                f"{role} study {sid!r} is not resident",
                                study_id=sid)
        return ws

    # -- fault hooks -------------------------------------------------------
    def _shed(self, lane) -> None:
        """Allocator-pressure response (real or injected OOM): drop one
        idle pooled session — never one with in-flight rows — so the
        retry runs against a smaller resident set."""
        victim = self.pool.shed(exclude=self.scheduler.active_studies()
                                | {lane.key[0]})
        if victim is not None:
            self.metrics.record_shed()

    def _poll_pool_faults(self) -> None:
        """The ``serve.pool`` injection site: a forced eviction of a
        study with live tiles — the eviction/re-upload race the
        ``stale_generation`` path exists for."""
        if self.injector is None:
            return
        for spec in self.injector.poll("serve.pool"):
            if spec.kind != "evict":
                continue
            victims = sorted(self.scheduler.active_studies())
            if not victims:
                continue
            self.metrics.record_fault("serve.pool", "evict")
            self.pool.drop(victims[0])
            self.scheduler.invalidate_study(victims[0])

    # -- the loop ----------------------------------------------------------
    def step(self) -> bool:
        """One loop turn: fire pool faults (when armed), expire lapsed
        deadlines (queued AND active), activate queued requests up to
        ``max_active``, run one coalesced tile, retire finished
        requests. Returns True while work remains."""
        self._poll_pool_faults()
        now = time.monotonic()
        for handle in self.queue.expired(now):
            handle.reject(Rejection(
                "timeout",
                f"request waited past its {self.config.timeout_s}s "
                f"deadline in the admission queue",
                {"request_id": handle.request_id}))
            self.metrics.record_rejection("timeout")
        for handle in self._active:
            if (not handle.done and handle.deadline is not None
                    and now > handle.deadline):
                # cooperative cancellation: the deadline followed the
                # request out of the queue; draws done so far degrade it
                self.scheduler.cancel(handle, Rejection(
                    "deadline",
                    "request exceeded its deadline while executing",
                    {"request_id": handle.request_id}))
        self._active = [h for h in self._active if not h.done]
        while len(self._active) < self.config.max_active and len(self.queue):
            handle = self.queue.pop()
            if handle is None:
                break
            self._activate(handle)
        self.metrics.sample_queue_depth(len(self.queue))
        ran = self.scheduler.step()
        for handle in list(self._active):
            if handle.done:
                self._finish(handle)
                self._active.remove(handle)
        # keep in-flight studies out of eviction's reach
        self.pool.evict(exclude=self.scheduler.active_studies())
        return ran or bool(len(self.queue)) or bool(self._active)

    def _finish(self, handle) -> None:
        self.metrics.record_completion(
            handle, (handle.t_done or time.perf_counter())
            - handle.t_submit)
        if self.journal is not None:
            self.journal.append({"t": "terminal",
                                 "rid": handle.request_id,
                                 "status": handle.status})

    def run(self) -> None:
        """Drain synchronously: loop until queue and scheduler are empty."""
        while self.step():
            pass

    async def arun(self) -> None:
        """Asyncio driver: one tile per loop turn, yielding between
        tiles so client coroutines awaiting handles interleave."""
        import asyncio
        while self.step():
            await asyncio.sleep(0)

    async def wait(self, handle: RequestHandle):
        """Await one handle (pump the loop while it is pending)."""
        import asyncio
        while not handle.done:
            self.step()
            await asyncio.sleep(0)
        return handle

    # -- journal / recovery ------------------------------------------------
    def _journal_submit(self, handle: RequestHandle) -> None:
        if self.journal is None:
            return
        p = handle.params
        g = p["grouping"]
        self.journal.append({
            "t": "submit", "rid": handle.request_id,
            "study": handle.study_id, "method": handle.method,
            "permutations": handle.permutations,
            "key": _key_data(handle.key),
            "alternative": handle.alternative,
            "grouping": (None if g is None else
                         g.tolist() if isinstance(g, torch.Tensor)
                         else np.asarray(g).tolist()),
            "other": p["other"], "control": p["control"],
            "dimensions": p["dimensions"],
            "pcoa_method": p["pcoa_method"]})

    @classmethod
    def recover(cls, journal_path: str, *, pool: SessionPool,
                config: Optional[ServeConfig] = None):
        """Rebuild a service from a crashed one's journal.

        ``pool`` is the surviving ``SessionPool`` — sessions (and their
        hoists) live independently of the front-door state that
        crashed, so recovery re-hoists NOTHING. The journal's valid
        prefix is replayed: requests with a terminal record are done;
        the rest are resubmitted with their original key (a generator
        rebuilt from its journaled state) and their last journaled
        ``(cursor, count)``, so completed permutation blocks are not
        re-run and the finished p-values are bitwise what the
        uninterrupted run would have produced (orders are a pure
        function of the key; exceedance counts are order-independent
        sums). Returns ``(service, handles)`` where
        ``handles`` maps each recovered *original* request id to its
        new ``RequestHandle``.
        """
        records = list(journal_replay(journal_path))
        cfg = dataclasses.replace(config if config is not None
                                  else ServeConfig(),
                                  journal_path=journal_path)
        svc = cls(config=cfg, pool=pool)
        submits: dict = {}
        progress: dict = {}
        terminal: set = set()
        for r in records:
            t = r.get("t")
            if t == "submit":
                submits[r["rid"]] = r
            elif t == "progress":
                progress[r["rid"]] = r      # last one wins: the frontier
            elif t == "terminal":
                terminal.add(r["rid"])
        handles: dict = {}
        for rid, r in submits.items():
            if rid in terminal:
                continue
            try:
                h = svc.submit(
                    r["study"], r["method"],
                    grouping=(np.asarray(r["grouping"])
                              if r.get("grouping") is not None else None),
                    other=r.get("other"), control=r.get("control"),
                    permutations=r["permutations"],
                    key=_key_from_data(r["key"]),
                    alternative=r.get("alternative"),
                    dimensions=r.get("dimensions"),
                    pcoa_method=r.get("pcoa_method") or "fsvd")
            except Rejected:
                # the study did not survive the crash (pool rebuilt
                # smaller, say) — the request stays failed, structured
                continue
            pr = progress.get(rid)
            if pr is not None:
                h.resume_cursor = int(pr["cursor"])
                h.resume_count = int(pr["count"])
            # the old id will never get a terminal record of its own;
            # mark it re-mapped so a second recovery won't duplicate it
            if svc.journal is not None:
                svc.journal.append({"t": "terminal", "rid": rid,
                                    "status": "resubmitted",
                                    "as": h.request_id})
            handles[rid] = h
        return svc, handles

    # -- reporting ---------------------------------------------------------
    def report(self) -> dict:
        return serve_report(self)
