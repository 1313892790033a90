"""repro_torch.faults: the deterministic fault-injection plane.

The counterpart of ``repro/faults``.

Commodity/edge deployments make failures the common case, not the
exception — so before a real transport or out-of-core IO can be layered
on ``repro_torch.serve``, the service needs a *defined* fault model. This
package supplies the adversary half: seed-scheduled fault plans
(:class:`FaultPlan`) polled at injection points inside the serve
scheduler/service (:class:`FaultInjector`), deterministic enough that a
chaos run's surviving results can be gated bitwise against the
fault-free run. The recovery half — retry with backoff, per-lane
circuit breakers, deadlines, journal recovery — lives in
``repro_torch.serve``; this package only ever *causes* trouble.
"""

from repro_torch.faults.plan import (SITES, AllocFault, CompileFault, FaultError,
                               FaultEvent, FaultInjector, FaultPlan,
                               FaultSpec, PoisonError, StallFault,
                               TransientTileError, unit_hash)

__all__ = [
    "FaultPlan", "FaultSpec", "FaultInjector", "FaultEvent", "SITES",
    "FaultError", "TransientTileError", "AllocFault", "CompileFault",
    "StallFault", "PoisonError", "unit_hash",
]
