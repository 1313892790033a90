"""Device resolution and tile-snapping policy shared by every kernel.

The counterpart of ``repro/kernels/dispatch.py``. Its ``resolve_interpret``
rule (TPU-native on a TPU, the Pallas interpreter elsewhere) becomes
:func:`resolve_device`: the port runs on the card unless the caller asks
for the CPU, and raises rather than fall back when there is no card. On a
CPU tensor each kernel wrapper runs its plain PyTorch version; on a CUDA
tensor it launches its kernel or raises.

``pick_block``, ``clamp_block`` and ``snap_chunk`` are the reference's
backend-neutral snapping rules, kept verbatim. ``lane_geometry`` gives the
Hopper geometry in place of the TPU's 128-lane tiles: trailing tile dims
snap to a warp (32 threads) on the card and to the fp32 sublane (8) on the
CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

#: fp32 sublane multiple: the snap unit on the CPU (and for row-ish dims).
SUBLANE = 8
#: threads in a warp: the snap unit of trailing tile dims on the card.
WARP = 32

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card. Raise if a CUDA device is asked for and
    there is none: nothing falls back to the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def lane_geometry(device: DeviceLike) -> Tuple[int, int]:
    """(lane, floor) for trailing tile dims: warp-multiple tiles on the
    card, sublane-multiple tiles that may shrink to 1 on the CPU."""
    if torch.device(device).type == "cuda":
        return WARP, WARP
    return SUBLANE, 1


def pick_block(n: int, requested: int, lane: int = SUBLANE,
               floor: int = 1) -> int:
    """Largest multiple-of-``lane`` block <= requested (tiny n falls back
    to ``floor``)."""
    b = min(requested, n)
    if b >= lane:
        b -= b % lane
    return max(b, floor)


def clamp_block(n: int, requested: int) -> int:
    """Any block in [1, n]: ``max(min(requested, n), 1)``."""
    return max(min(requested, n), 1)


def snap_chunk(m: int, chunk: int) -> Tuple[int, int]:
    """(chunk, m_pad) for a 1-D condensed stream of length ``m``: snap the
    chunk to the 8-aligned condensed length so tiny problems are not padded
    to a full default chunk, then pad ``m`` up to a chunk multiple."""
    m8 = -(-max(m, 1) // SUBLANE) * SUBLANE
    chunk = max(min(chunk, m8), 1)
    return chunk, -(-m // chunk) * chunk


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: Optional[tuple] = None) -> None:
    """Raise unless ``t`` has ``dtype``, ``shape`` (when given) and is
    contiguous: what every kernel wrapper checks before it takes a pointer."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def same_device(*tensors: torch.Tensor) -> torch.device:
    """The one device all ``tensors`` lie on; raise if they differ."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands lie on different devices: {devices}")
    return devices.pop()
