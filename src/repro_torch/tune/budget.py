"""Backend byte budgets: what "fits in fast memory" means, per backend.

The counterpart of ``repro/tune/budget.py``. ``detect_budget()`` answers
the question every hand-picked tile constant used to answer implicitly:
how many bytes may a kernel's working set occupy and still stream at full
rate? The reference's three static columns stay as they are (``"tpu"``:
v5e VMEM; ``"cpu"``: an L2-class slice; ``"gpu"``: an L2-class slice), so
a reference profile JSON loads and the CPU column prices the plain
versions exactly as the reference prices its interpreter.

The port's own column is the card, read from
``torch.cuda.get_device_properties``: ``working_bytes`` is the L2 cache
(50 MB on an H100), where a production panel and its output strip stay
resident; ``shared_bytes`` the shared memory one block may opt in to (227
KB), where ``permute_reduce`` holds its row of x and its fp64 reduction;
``capacity_bytes`` the device memory (80 GB); the bandwidth is the H100's
static HBM3 rate until ``calibrate`` measures it. ``detect_budget()``
defaults to the card and raises without one; ``detect_budget("cpu")``
gives the CPU column.

``calibrate()`` upgrades the static rate constants to measured ones with
a two-point timed probe (one small pass dominated by launch latency, one
large pass dominated by stream bandwidth); on the card it times with CUDA
events. The pass is ``stream_pass``, one kernel that reads and writes one
fp32 an element: 8 bytes, the figure the fit divides by (an eager
``x * 2 + 1`` is two kernels and a temporary, 16 bytes an element, and
halved the measured bandwidth). ``calibrate(mode="probe")`` counts the
same pass's bytes with ``obs.probe`` instead of timing it. Profiles
round-trip through JSON.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional, Union

import torch

from repro_torch.kernels.dispatch import resolve_device

__all__ = ["BackendBudget", "detect_budget", "calibrate", "stream_pass",
           "save_profile", "load_profile"]

#: bytes per fp32 element: every budget below is quoted in bytes
_FP32 = 4
#: the reference's TPU column bandwidth (v5e HBM, its ``launch.mesh.HBM_BW``)
TPU_HBM_BW = 819e9
#: an H100 SXM's HBM3 rate (NVIDIA's data sheet): the card column's static
#: bandwidth until calibrated
H100_HBM_BW = 3.35e12
#: the names of the reference's static columns
REFERENCE_COLUMNS = ("tpu", "cpu", "gpu")


@dataclasses.dataclass(frozen=True)
class BackendBudget:
    """One backend's memory-system description, as the solver sees it.

    * ``working_bytes`` — the budget a kernel step's tunable resident set
      must fit (VMEM on a TPU, an L2-class slice on the CPU and the
      reference's GPU column, the L2 cache on the card);
    * ``capacity_bytes`` — the next-level pool (HBM/L3), for sanity
      bounds only;
    * ``bandwidth`` / ``latency`` — stream bandwidth (bytes/s) and
      per-launch latency (s), static unless calibrated;
    * ``source`` — ``"default"``, ``"calibrated"``, ``"probed"`` or
      ``"profile"``;
    * ``shared_bytes`` — the card only: shared memory one block may opt
      in to, which ``permute_reduce``'s per-block resident set must fit;
    * ``device`` — the card only: its name.
    """

    backend: str
    working_bytes: int
    capacity_bytes: int
    bandwidth: float
    latency: float
    source: str = "default"
    shared_bytes: Optional[int] = None
    device: Optional[str] = None

    @property
    def working_floats(self) -> float:
        return self.working_bytes / _FP32

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "BackendBudget":
        return BackendBudget(**d)


#: the reference's static columns, value for value
_DEFAULTS = {
    "tpu": dict(working_bytes=16 * 2**20, capacity_bytes=16 * 2**30,
                bandwidth=TPU_HBM_BW, latency=3e-6),
    "cpu": dict(working_bytes=1 * 2**20, capacity_bytes=32 * 2**20,
                bandwidth=3e10, latency=30e-6),
    "gpu": dict(working_bytes=8 * 2**20, capacity_bytes=2 * 2**30,
                bandwidth=9e11, latency=5e-6),
}


def _card_budget(device: torch.device) -> BackendBudget:
    props = torch.cuda.get_device_properties(device)
    shared = getattr(props, "shared_memory_per_block_optin", None)
    l2 = getattr(props, "L2_cache_size", None)
    if not shared or not l2:
        raise RuntimeError(f"torch {torch.__version__} does not report the "
                           f"card's opt-in shared memory and L2 size")
    return BackendBudget(backend="cuda", working_bytes=int(l2),
                         capacity_bytes=int(props.total_memory),
                         bandwidth=H100_HBM_BW, latency=5e-6,
                         source="default", shared_bytes=int(shared),
                         device=props.name)


def detect_budget(device: Union[str, torch.device, None] = None
                  ) -> BackendBudget:
    """The static budget of ``device``: ``None`` (the default) or a CUDA
    device is the card, read from its properties (raises without a card);
    ``"cpu"``, ``"tpu"`` and ``"gpu"`` are the reference's columns."""
    if isinstance(device, str) and device in REFERENCE_COLUMNS:
        return BackendBudget(backend=device, source="default",
                             **_DEFAULTS[device])
    dev = resolve_device(device)
    if dev.type == "cpu":
        return detect_budget("cpu")
    return _card_budget(dev)


def stream_pass(x: torch.Tensor) -> torch.Tensor:
    """The calibration's elementwise pass: one kernel that reads ``x`` and
    writes ``2x``, two fp32 an element."""
    return torch.mul(x, 2.0)


def _time_pass(x: torch.Tensor, reps: int = 5) -> float:
    """Median seconds of one ``stream_pass`` over ``x``; on the card each
    pass is timed with CUDA events."""
    stream_pass(x)                                   # warm-up
    ts = []
    for _ in range(reps):
        if x.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            stream_pass(x)
            stop.record()
            stop.synchronize()
            ts.append(start.elapsed_time(stop) * 1e-3)
        else:
            t0 = time.perf_counter()
            stream_pass(x)
            ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def calibrate(base: Optional[BackendBudget] = None, *,
              small: int = 1 << 12, large: int = 1 << 22,
              reps: int = 5, mode: str = "wall") -> BackendBudget:
    """Fit the budget's rate constants from streaming passes.

    Both modes run ``stream_pass`` on the budget's own device (the card
    for ``backend="cuda"``, the CPU otherwise). ``mode="wall"`` times a
    small (latency-dominated) and a large (bandwidth-dominated) pass and
    solves the two-point linear fit: a pass over N floats costs latency +
    8N/bandwidth bytes. ``mode="probe"`` is deterministic: it counts the
    bytes one pass over ``large`` floats moves (``obs.probe.
    probe_stream_pass``) and scales the budget's bandwidth by 8·large over
    that count, so a pass that moved more than the modeled two fp32 an
    element would price streams proportionally slower; latency stays as
    it was and ``source`` becomes ``"probed"``. Capacities stay static:
    only rate constants are measured.
    """
    if mode not in ("wall", "probe"):
        raise ValueError(f"calibrate mode must be 'wall' or 'probe', "
                         f"got {mode!r}")
    b = base or detect_budget()
    device = resolve_device("cuda" if b.backend == "cuda" else "cpu")
    if mode == "probe":
        from repro_torch.obs.probe import probe_stream_pass
        rec = probe_stream_pass(large, device=device)
        factor = max(rec.bytes_corrected / (2.0 * _FP32 * large), 1e-6)
        return dataclasses.replace(b, bandwidth=b.bandwidth / factor,
                                   source="probed")
    t_small = _time_pass(torch.ones((small,), device=device), reps)
    t_large = _time_pass(torch.ones((large,), device=device), reps)
    # each element moves two fp32 (read + write) a pass
    bytes_small, bytes_large = 2 * _FP32 * small, 2 * _FP32 * large
    dt = max(t_large - t_small, 1e-12)
    bandwidth = (bytes_large - bytes_small) / dt
    latency = max(t_small - bytes_small / bandwidth, 0.0)
    return dataclasses.replace(b, bandwidth=bandwidth, latency=latency,
                               source="calibrated")


def save_profile(budget: BackendBudget, path: str) -> None:
    """Persist a budget (typically a calibrated one) as JSON."""
    with open(path, "w") as f:
        json.dump(budget.to_dict(), f, indent=2)


def load_profile(path: str) -> BackendBudget:
    """Reload a ``save_profile`` JSON (the reference's too); its source
    becomes ``"profile"``."""
    with open(path) as f:
        d = json.load(f)
    d["source"] = "profile"
    return BackendBudget.from_dict(d)
