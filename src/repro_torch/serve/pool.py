"""SessionPool: a bounded LRU of live Workspace sessions, keyed by study.

The counterpart of ``repro/serve/pool.py``.

The paper's economics inverted the bottleneck: when every analysis is a
cache-resident pass, the server's scarce resource is no longer compute
but *resident hoists* — each pooled study is exactly its ``HoistCache``
(condensed distances, operator means, ranks, moments, coordinates), and
``HoistCache.nbytes()`` prices it: the bytes of every tensor storage
the cache reaches, on the card its device memory. This pool is
therefore an LRU over hoist bytes:

* ``admit`` creates (or refreshes) the study's ``Workspace`` — a
  re-upload routes through ``Workspace.refresh``, which drops every
  cached artifact and bumps ``generation``, so in-flight work pinned to
  the old generation keeps its own (still-alive) arrays while new
  requests see only the new data;
* ``get`` touches LRU order, so actively-served studies stay resident;
* eviction enforces both a session-count cap and a byte budget,
  skipping studies with in-flight work (the scheduler's pin set) —
  evicting a study only drops the *cache*; a later upload rebuilds it.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from repro_torch.api.config import ExecConfig
from repro_torch.api.workspace import Workspace


class SessionPool:
    """LRU pool of ``Workspace`` sessions (see module docstring).

    ``max_sessions`` bounds the count; ``max_bytes`` (None = unbounded)
    bounds the summed ``HoistCache.nbytes()`` — checked after each admit
    and on ``evict()``, oldest-touched first.
    """

    def __init__(self, max_sessions: int = 8,
                 max_bytes: Optional[int] = None):
        self.max_sessions = int(max_sessions)
        self.max_bytes = max_bytes
        self._sessions: "OrderedDict[str, Workspace]" = OrderedDict()
        self.evictions = 0

    # -- admission ---------------------------------------------------------
    def admit(self, study_id: str, config: ExecConfig, *, dm=None,
              features=None, metric=None) -> Workspace:
        """Create the study's session, or refresh it on re-upload.

        Validation/canonicalization is the Workspace's own admission
        path; the refresh path bumps ``generation`` so every scheduler
        lane keyed on the old generation stays internally consistent
        while new requests bind the new data. The new/refreshed session
        is touched most-recently-used, then the budgets are enforced
        (never evicting the session just admitted).
        """
        if study_id in self._sessions:
            ws = self._sessions[study_id]
            ws.refresh(dm=dm, features=features, metric=metric)
            self._sessions.move_to_end(study_id)
        else:
            if features is not None:
                ws = Workspace.from_features(features, metric=metric,
                                             config=config)
            else:
                ws = Workspace(dm, config=config)
            self._sessions[study_id] = ws
        self.evict(exclude={study_id})
        return ws

    def get(self, study_id: str) -> Optional[Workspace]:
        """The study's live session (touching LRU order), or None."""
        ws = self._sessions.get(study_id)
        if ws is not None:
            self._sessions.move_to_end(study_id)
        return ws

    # -- accounting --------------------------------------------------------
    def nbytes(self) -> int:
        """Summed resident hoist bytes across every pooled session."""
        return sum(ws.cache.nbytes() for ws in self._sessions.values())

    def nbytes_by_study(self) -> dict:
        return {sid: ws.cache.nbytes()
                for sid, ws in self._sessions.items()}

    def __len__(self) -> int:
        return len(self._sessions)

    def __contains__(self, study_id: str) -> bool:
        return study_id in self._sessions

    def studies(self):
        return list(self._sessions.keys())

    # -- eviction ----------------------------------------------------------
    def drop(self, study_id: str) -> bool:
        """Force-remove one session unconditionally (the fault plane's
        eviction-race lever; ordinary budget pressure uses ``evict``).
        The caller owns the consequences — in-flight requests bound to
        the dropped study must be terminated via the scheduler's
        ``invalidate_study``, which is exactly what the service does."""
        if study_id in self._sessions:
            del self._sessions[study_id]
            self.evictions += 1
            return True
        return False

    def shed(self, exclude=frozenset()) -> Optional[str]:
        """Evict ONE least-recently-used victim outside ``exclude`` —
        the allocator-pressure response (a real or injected OOM wants
        bytes back *now*, not budget convergence). Returns the evicted
        study id, or None when every session is excluded."""
        for sid in self._sessions:
            if sid not in exclude:
                del self._sessions[sid]
                self.evictions += 1
                return sid
        return None

    def evict(self, exclude=frozenset()) -> list:
        """Enforce both budgets, least-recently-used first; ``exclude``
        names studies that must survive (the just-admitted session, the
        scheduler's in-flight pins). Returns the evicted study ids. May
        leave the pool over budget when everything else is excluded —
        correctness over the cap: never drop a session mid-request."""
        evicted = []

        def victims():
            return [sid for sid in self._sessions if sid not in exclude]

        while len(self._sessions) > self.max_sessions and victims():
            sid = victims()[0]
            del self._sessions[sid]
            evicted.append(sid)
        if self.max_bytes is not None:
            while self.nbytes() > self.max_bytes and victims():
                sid = victims()[0]
                del self._sessions[sid]
                evicted.append(sid)
        self.evictions += len(evicted)
        return evicted
