"""repro_torch.serve: the multi-tenant analysis front door.

The counterpart of ``repro/serve``, on the card unless
``ServeConfig(device="cpu")`` asks for the CPU.

The library made each analysis cheap (hoist-once sessions, fused
condensed permutation tiles); this package makes *many concurrent
studies* cheap: a byte-budgeted LRU pool of live ``Workspace`` sessions
(``pool``), a scheduler that coalesces permutation requests from
different clients into shared padded tiles and streams anytime p-value
bounds as tiles complete (``scheduler``), bounded admission with
structured rejection (``admission``), and full ``repro_torch.obs`` binding
(``metrics``). ``AnalysisService`` in ``service`` is the assembled
front door; ``python -m repro_torch.launch.serve --smoke`` drives it end to
end.
"""

from repro_torch.serve.admission import (Rejected, Rejection,
                                         RequestQueue, validate_upload)
from repro_torch.serve.metrics import ServeMetrics, serve_report
from repro_torch.serve.pool import SessionPool
from repro_torch.serve.scheduler import (Lane, RetryPolicy, StreamUpdate,
                                         TileScheduler, exceedances,
                                         operand_fingerprint, partial_bounds)
from repro_torch.serve.service import (METHODS, AnalysisService,
                                       RequestHandle, ServeConfig)

__all__ = [
    "AnalysisService", "ServeConfig", "RequestHandle", "METHODS",
    "SessionPool", "TileScheduler", "Lane", "StreamUpdate", "RetryPolicy",
    "RequestQueue", "Rejected", "Rejection", "validate_upload",
    "ServeMetrics", "serve_report", "partial_bounds", "exceedances",
    "operand_fingerprint",
]
