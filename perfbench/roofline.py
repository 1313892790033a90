"""The least time of a call from its work count and the table of peaks.

``least(count, peak)`` is the larger of the bytes over the device's memory
bandwidth and the operations over its peak rate at the count's precision,
and says which of the two bounds it. The peaks are the published ones
(``peaks.json``); a share of them is stated with the card's power limit
beside it. A device the table does not hold has no least time, so nothing
is reported against it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peak_for(device_name: str, path: Path = PEAKS) -> Optional[dict]:
    """The peaks entry whose ``match`` is part of ``device_name``."""
    for entry in json.loads(path.read_text())["devices"]:
        if entry["match"] in device_name:
            return entry
    return None


def least(count: dict, peak: Optional[dict]) -> Optional[dict]:
    """``{"seconds", "bound"}``: the least time of ``count`` on ``peak``,
    ``bound`` being ``"bytes"`` or ``"operations"``; None without a peak."""
    if peak is None:
        return None
    by_bytes = count["bytes"] / peak["bytes_per_s"]
    by_ops = count["ops"] / peak["ops_per_s"][count["precision"]]
    if by_ops >= by_bytes:
        return {"seconds": by_ops, "bound": "operations"}
    return {"seconds": by_bytes, "bound": "bytes"}
