"""Public wrapper for the pairwise-panel kernel.

The counterpart of ``repro/kernels/pairwise_ops.py``. It checks the
operands and dispatches: the CUDA kernel on a CUDA tensor, the plain
chunked panel (``pairwise_ref.pairwise_panel_ref``) on a CPU tensor. The
kernel masks ragged rows and features itself, so nothing is padded (the
reference pads the column blocks and the feature axis here).
"""

from __future__ import annotations

import torch

from repro_torch.dist.metrics import Metric, get_metric
from repro_torch.kernels.dispatch import require, same_device
from repro_torch.kernels.pairwise import pairwise_panel
from repro_torch.kernels.pairwise_ref import pairwise_panel_ref
from repro_torch.obs.compile import note_trace


def pairwise_panel_op(xi: torch.Tensor, x: torch.Tensor,
                      metric: Metric | str = "braycurtis") -> torch.Tensor:
    """One distance row panel: (bm, d) × (n, d) → (bm, n), the metric's
    elementwise reduce fused over the features."""
    metric = get_metric(metric)
    if xi.ndim != 2 or x.ndim != 2 or xi.shape[1] != x.shape[1]:
        raise ValueError(f"expected (bm, d) and (n, d) tables, got "
                         f"{tuple(xi.shape)} and {tuple(x.shape)}")
    require(xi, "xi", torch.float32)
    require(x, "x", torch.float32)
    device = same_device(xi, x)
    note_trace("kernels.pairwise_panel",
               (tuple(xi.shape), tuple(x.shape), metric.name, x.dtype,
                device.type))
    if device.type == "cpu":
        return pairwise_panel_ref(xi, x, metric)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return pairwise_panel(xi, x, metric.kind)
