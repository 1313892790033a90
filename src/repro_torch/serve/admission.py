"""Admission control: structured rejection + the bounded request queue.

The counterpart of ``repro/serve/admission.py``.

A service front door fails differently from a library: a bad upload or
an overloaded queue must come back as a structured error payload the
client can branch on, never a traceback, and never by silently holding
the connection. This module owns both halves:

* ``Rejection`` / ``Rejected`` — the error currency. Every refusal has a
  stable machine-readable ``code`` (``non_finite``, ``too_large``,
  ``bad_shape``, ``queue_full``, ``timeout``, ``unknown_study``,
  ``bad_request`` — and, from the fault/recovery plane:
  ``circuit_open`` when a lane's breaker quarantined the request,
  ``stale_generation`` when its study was re-uploaded or evicted
  mid-flight, ``deadline`` when an *active* request was cooperatively
  cancelled past its deadline, ``cancelled`` for client aborts, and
  ``unavailable`` when lane compilation failed repeatedly), a human
  message, and a detail dict; ``payload()`` is the wire form.
* ``validate_upload`` — the data gate, reusing the port's own checks
  (``core.validation.ensure_finite``; the ``n > MAX_TRIANGLE_N`` int32
  triangle guard every condensed-indexed kernel enforces) so the service
  refuses exactly what the analysis stack would refuse, just politely
  and *before* any O(n²) work. A tensor is checked where it lies, an
  array on the host.
* ``RequestQueue`` — a bounded FIFO with per-request deadlines. Pushing
  past ``max_depth`` rejects immediately (backpressure, not unbounded
  buffering); requests whose deadline lapses while queued are expired
  with a ``timeout`` rejection instead of running stale.

Tune-solve at admission happens one layer up: ``AnalysisService.upload``
admits each study through a ``Workspace`` built on
``ExecConfig(auto=True)``, so the pool only ever holds sessions whose
tile geometry was solved against their own (n, d).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core.distance_matrix import MAX_TRIANGLE_N
from repro_torch.core.validation import ensure_finite


@dataclasses.dataclass(frozen=True)
class Rejection:
    """One structured refusal: a stable code, a human message, detail."""

    code: str
    message: str
    detail: dict = dataclasses.field(default_factory=dict)

    def payload(self) -> dict:
        """The wire form — what a transport would serialize back."""
        return {"error": {"code": self.code, "message": self.message,
                          "detail": dict(self.detail)}}


class Rejected(Exception):
    """Raised internally wherever admission refuses; carries the
    ``Rejection`` so the front door can return ``payload()`` instead of
    letting a traceback escape."""

    def __init__(self, rejection: Rejection):
        super().__init__(rejection.message)
        self.rejection = rejection

    @classmethod
    def make(cls, code: str, message: str, **detail) -> "Rejected":
        return cls(Rejection(code, message, detail))


def validate_upload(data=None, features=None, *,
                    max_n: int = MAX_TRIANGLE_N) -> tuple:
    """Gate one study upload; returns ``(kind, n)`` or raises ``Rejected``.

    ``kind`` is ``"dm"`` (square distance matrix) or ``"features"``
    ((n, d) table). Checks, in order: exactly one operand; array-shaped;
    plausible dimensionality; ``n`` within both the service cap and the
    int32 triangle bound; finite everywhere (the library's own fused
    single-pass ``ensure_finite``). All failures surface as structured
    ``Rejection`` payloads — the service never shows a client a
    traceback for bad data.
    """
    if (data is None) == (features is None):
        raise Rejected.make("bad_request",
                            "upload exactly one of data= (square distance "
                            "matrix) or features= ((n, d) table)")
    kind = "dm" if data is not None else "features"
    given = data if data is not None else features
    arr = (given if isinstance(given, torch.Tensor)
           else torch.as_tensor(np.asarray(given)))
    if arr.ndim != 2:
        raise Rejected.make("bad_shape",
                            f"expected a 2-d array, got shape "
                            f"{tuple(arr.shape)}",
                            shape=list(arr.shape))
    if kind == "dm" and arr.shape[0] != arr.shape[1]:
        raise Rejected.make("bad_shape",
                            f"distance matrix must be square, got "
                            f"{arr.shape[0]}x{arr.shape[1]}",
                            shape=list(arr.shape))
    n = int(arr.shape[0])
    cap = min(int(max_n), MAX_TRIANGLE_N)
    if n > cap:
        raise Rejected.make(
            "too_large",
            f"n={n} exceeds this service's limit of {cap} samples "
            f"(int32 condensed triangle indexing is exact only to "
            f"n={MAX_TRIANGLE_N})",
            n=n, max_n=cap)
    try:
        ensure_finite(arr, what=("distance matrix" if kind == "dm"
                                 else "feature table"))
    except ValueError as e:
        raise Rejected.make("non_finite", str(e), n=n) from None
    return kind, n


class RequestQueue:
    """Bounded FIFO of pending request handles with deadlines.

    ``push`` refuses (``queue_full``) once ``max_depth`` requests wait —
    admission backpressure instead of unbounded memory. ``pop`` returns
    the oldest still-live handle; handles whose deadline lapsed while
    queued are returned by ``expired()`` for the service to fail with a
    ``timeout`` rejection. Deadlines use the monotonic clock.
    """

    def __init__(self, max_depth: int):
        self.max_depth = int(max_depth)
        self._q: deque = deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, handle, timeout_s: Optional[float]) -> None:
        if len(self._q) >= self.max_depth:
            raise Rejected.make(
                "queue_full",
                f"request queue is full ({self.max_depth} pending); "
                f"retry later",
                max_depth=self.max_depth)
        handle.deadline = (time.monotonic() + timeout_s
                           if timeout_s is not None else None)
        self._q.append(handle)

    def expired(self, now: Optional[float] = None) -> list:
        """Remove and return every queued handle past its deadline."""
        now = time.monotonic() if now is None else now
        out = [h for h in self._q
               if h.deadline is not None and now > h.deadline]
        for h in out:
            self._q.remove(h)
        return out

    def pop(self):
        """The oldest live handle, or None when empty."""
        return self._q.popleft() if self._q else None
