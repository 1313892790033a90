"""Deterministic, seed-scheduled fault injection for the serving plane.

The counterpart of ``repro/faults/plan.py``, pure Python over
``hashlib`` as it is: for a plan seed, a fault fires at the same site
invocations as in the reference.

The service's fault model has to be *testable*, which rules out the two
easy designs: real chaos (kill -9, cgroup throttling) is not
reproducible inside a unit test, and ``random.random() < rate`` checks
drift with call interleavings. This module's schedule is a pure
function of ``(plan.seed, site, invocation_index)``: every injection
site keeps its own invocation counter, and whether fault spec *i* fires
at invocation *k* of site *s* is decided by a counter-keyed hash —
``unit_hash(seed, f"{s}:{i}", k) < rate`` — so the same plan against
the same request sequence injects the same faults in the same places,
run after run, regardless of wall clock or scheduling jitter. That
determinism is what lets the chaos suite assert the strong property:
*completed* requests' p-values are bitwise-equal to the fault-free run.

Fault classes (``FaultSpec.kind``), matching the failure taxonomy the
recovery plane in ``repro_torch.serve`` handles:

* ``error``   — transient tile-compute failure (device hiccup);
* ``oom``     — simulated allocator out-of-memory on a tile;
* ``nan``     — NaN-poisoned tile statistics (silent numeric corruption,
  the nastiest class: without an output admission check it would skew
  exceedance counts instead of crashing);
* ``slow``    — a tile that completes late (sleeps ``delay_s`` inside
  the timed window — exercises the straggler flagger / SLO breaches);
* ``stall``   — a tile that *begins but never completes* (the step span
  is left open) — exercises the ``StepMonitor`` watchdog escalation;
* ``compile`` — lane hoist/compile failure at activation;
* ``evict``   — a session-pool eviction race: a study with live tiles
  is force-dropped, and its in-flight requests must terminate with a
  structured ``stale_generation`` rejection, not a crash.

Injection points are threaded through ``serve/scheduler.py`` (site
``serve.tile``), ``serve/service.py`` (``serve.hoist``, ``serve.pool``)
— and they are zero-cost no-ops when disabled: a service built without
a plan holds no injector at all (``injector is None`` guards), so the
hot tile loop pays nothing for the capability.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import Counter
from typing import Optional, Tuple

#: the sites the serving plane polls, and the kinds each site understands
SITES = {
    "serve.tile": ("error", "oom", "nan", "slow", "stall"),
    "serve.hoist": ("compile",),
    "serve.pool": ("evict",),
}


# --------------------------------------------------------------------------
# The fault taxonomy as an exception hierarchy
# --------------------------------------------------------------------------
class FaultError(RuntimeError):
    """Base of every injected fault. Subclasses ``RuntimeError`` on
    purpose: the recovery plane catches ``(FaultError, RuntimeError)``
    around tile execution, so a real transient error takes the same retry
    path as an injected one. A failed kernel build or launch
    (``kernels._build.KernelError``) and any CUDA error are the
    exceptions: the scheduler re-raises them, since a CUDA error is
    sticky and a retry cannot succeed."""


class TransientTileError(FaultError):
    """A tile-compute failure expected to succeed on retry."""


class AllocFault(FaultError):
    """Simulated allocator OOM — besides the retry, the service sheds
    pool bytes (evicts an idle session) before the next attempt."""


class CompileFault(FaultError):
    """Lane hoist/compile failure at request activation."""


class StallFault(FaultError):
    """A tile that began but never completed: the scheduler leaves the
    step span OPEN, so the next loop turn's watchdog heartbeat must
    escalate it into the retry path."""


class PoisonError(FaultError):
    """Raised by the scheduler's own tile-output admission check when a
    tile returns non-finite statistics (whether injected or real)."""


def unit_hash(seed: int, label: str, index: int) -> float:
    """Deterministic uniform in [0, 1) from ``(seed, label, index)``.

    One stable hash serves both the injector's fire decisions and the
    retry plane's backoff jitter — nothing in the fault/recovery path
    consumes ambient randomness, which is precisely why a chaos run is
    replayable."""
    h = hashlib.blake2b(f"{seed}:{label}:{index}".encode(),
                       digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault class at one injection site.

    ``rate`` fires probabilistically (by counter hash — deterministic
    for a fixed plan seed); ``at`` names explicit invocation indices
    that always fire (for pinpoint regression tests). ``max_fires``
    bounds the total (None = unbounded), ``delay_s`` is the sleep for
    ``slow``/``stall`` kinds.
    """

    site: str
    kind: str
    rate: float = 0.0
    at: Tuple[int, ...] = ()
    max_fires: Optional[int] = None
    delay_s: float = 0.0

    def __post_init__(self):
        kinds = SITES.get(self.site)
        if kinds is None:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"expected one of {sorted(SITES)}")
        if self.kind not in kinds:
            raise ValueError(f"site {self.site!r} does not understand "
                             f"kind {self.kind!r}; expected one of {kinds}")
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seed plus the fault specs it schedules (frozen, hashable-ish).

    ``FaultPlan.chaos(seed)`` builds the representative mixed plan the
    chaos suite sweeps; tests compose exact plans from specs directly.
    """

    seed: int = 0
    specs: Tuple[FaultSpec, ...] = ()

    @staticmethod
    def chaos(seed: int = 0, *, tile_error: float = 0.08,
              oom: float = 0.02, nan: float = 0.02, slow: float = 0.02,
              compile_rate: float = 0.05, evict: float = 0.0,
              delay_s: float = 0.0) -> "FaultPlan":
        """The mixed chaos-soak plan: every transient class at once.

        ``stall`` and ``evict`` default off here (each has its own
        targeted scenario in the suite) but can be dialed in."""
        specs = []
        if tile_error:
            specs.append(FaultSpec("serve.tile", "error", rate=tile_error))
        if oom:
            specs.append(FaultSpec("serve.tile", "oom", rate=oom))
        if nan:
            specs.append(FaultSpec("serve.tile", "nan", rate=nan,
                                   max_fires=4))
        if slow:
            specs.append(FaultSpec("serve.tile", "slow", rate=slow,
                                   delay_s=delay_s))
        if compile_rate:
            specs.append(FaultSpec("serve.hoist", "compile",
                                   rate=compile_rate, max_fires=2))
        if evict:
            specs.append(FaultSpec("serve.pool", "evict", rate=evict,
                                   max_fires=1))
        return FaultPlan(seed=seed, specs=tuple(specs))


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault that actually fired (the injector's audit trail)."""

    site: str
    kind: str
    index: int          # the site invocation it fired at


class FaultInjector:
    """Polls a :class:`FaultPlan` at named injection sites.

    ``poll(site)`` advances that site's invocation counter and returns
    the specs firing at this invocation (usually empty). The decision
    is a pure function of (plan seed, spec position, invocation index),
    so two services running identical request sequences under the same
    plan observe identical fault schedules. ``fires`` is the audit
    trail the serve metrics fold into ``serve_report()``.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._counts: Counter = Counter()
        self._fired: Counter = Counter()
        self.fires: list = []

    def poll(self, site: str) -> list:
        """The specs firing at this invocation of ``site``."""
        index = self._counts[site]
        self._counts[site] = index + 1
        out = []
        for i, spec in enumerate(self.plan.specs):
            if spec.site != site:
                continue
            if spec.max_fires is not None and self._fired[i] >= spec.max_fires:
                continue
            fire = index in spec.at or (
                spec.rate > 0.0
                and unit_hash(self.plan.seed, f"{site}:{i}", index)
                < spec.rate)
            if fire:
                self._fired[i] += 1
                self.fires.append(FaultEvent(site, spec.kind, index))
                out.append(spec)
        return out

    def invocations(self, site: str) -> int:
        return self._counts[site]

    def summary(self) -> dict:
        """Fired counts by ``site:kind`` — the report's injected view."""
        tally: Counter = Counter()
        for ev in self.fires:
            tally[f"{ev.site}:{ev.kind}"] += 1
        return dict(tally)
