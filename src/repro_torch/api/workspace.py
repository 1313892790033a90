"""Workspace: hoist-once analysis sessions over one distance matrix.

The counterpart of ``repro/api/workspace.py``. A study runs several
analyses on the same matrix back to back; ``Workspace`` is the session
that lets each O(n²) hoist run once for all of them:

* construction validates and canonicalizes the matrix once: finite
  check, then the fused symmetric + hollow check (on the card one
  ``symhollow`` launch), fp32 on ``config.device`` (``None``: the card).
  A ``DistanceMatrix`` that is already validated is trusted (paper §4.3);
* the shared hoists live behind a lazy ``HoistCache`` keyed by artifact:
  the operator means (``operator``), the materialized Gower matrix
  (``gram``: on the card the ``center`` kernel pair), the condensed
  distances (``condensed``), the condensed ranks (``ranks``), the
  condensed normalization moments (``moments``) and whole PCoA solutions
  (``coords``), each built on first use and reused by every later
  analysis of the session;
* every analysis threads the session's one ``ExecConfig`` through
  ``core.pcoa`` and ``stats.engine`` and returns ``OrdinationResult`` or
  ``PermutationTestResult``. A config with auto knobs
  (``ExecConfig(auto=True)``) is resolved by ``repro_torch.tune`` against
  the admitted data's (n, d) at admission and on ``refresh``:
  ``config_requested`` keeps what was asked for, ``config`` the concrete
  knobs, ``tuned`` the solver's record (``report()`` carries it).

The free functions (``core.mantel.mantel``, ``stats.permanova``,
``stats.anosim``, ``stats.permdisp``, ``stats.partial_mantel``) are thin
wrappers over a one-shot Workspace, so a session changes how often D is
read, never the answer.

``Workspace.from_features`` opens the session one step upstream: the
distances are produced panel by panel in condensed layout
(``repro_torch.dist.pairwise_condensed``, on the card ``pairwise_panel``
launches), with the operator means and the Mantel moments taken from the
same sweep, and every analysis runs without an n×n matrix: the Mantel
family gathers condensed storage (``permute_reduce``), ANOSIM walks its
condensed ranks (``within_sums``), PCoA and PERMANOVA run through the
condensed operator. The square builds left are
opt-ins: ``gram`` for eigh or materialized ordination, and the
``"square"`` key when ``ws.dm`` itself is asked for. ``refresh()`` drops
the whole cache (generation-counted) when the data change.

Test seams: each test method takes ``orders=`` and ``pcoa``/``permdisp``
take ``omega=``, passed through to the engine and the solver. The port's
seeds draw other numbers than JAX's keys, so the parity tests hand the
reference's orders and sketch in through them.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import Counter
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.api.config import ExecConfig
from repro_torch.api.results import OrdinationResult
from repro_torch.core.distance_matrix import (DistanceMatrix,
                                              condensed_to_square)
from repro_torch.core.mantel import MantelStatistic, condensed_moments_vec
from repro_torch.core.operators import (CenteredGramOperator,
                                        CondensedCenteredGramOperator)
from repro_torch.core.pcoa import DEFAULT_SEED, materialized_gram
from repro_torch.core.pcoa import pcoa as _pcoa
from repro_torch.core.pcoa import resolve_dimensions, sketch_width
from repro_torch.core.validation import ensure_finite
from repro_torch.dist import condensed_size, get_metric, pairwise_condensed
from repro_torch.dist.driver import production_route
from repro_torch.kernels.dispatch import clamp_block, resolve_device
from repro_torch.obs.ledger import FEATURE_HOIST_PASSES, HOIST_PASSES
from repro_torch.obs.report import ObsSession, RunReport, build_report
from repro_torch.obs.trace import NULL_OBS
from repro_torch.stats import engine
from repro_torch.stats.anosim import AnosimStatistic, rank_transform_condensed
from repro_torch.stats.engine import WORKSPACE_BATCH, PermutationTestResult
from repro_torch.stats.partial_mantel import (COLLINEAR_TOL,
                                              PartialMantelPallasStatistic,
                                              PartialMantelStatistic,
                                              _residualize)
from repro_torch.stats.permanova import (PermanovaOperatorStatistic,
                                         PermanovaStatistic)
from repro_torch.stats.permdisp import PermdispStatistic


class HoistCache:
    """Keyed store for a session's shared hoisted artifacts, with per-key
    hit/miss counters, so "the O(n²) hoist ran once" is a testable
    property.

    Keys are artifact names ("operator", "gram", "condensed", "ranks",
    "moments") or tuples whose first element is the artifact name
    (("coords", k, method, sketch fingerprint)). ``misses[key]`` counts
    builds, ``hits[key]`` reuses.

    When a Workspace binds its ``ObsSession`` (``bind_obs``), every miss
    runs under a ``hoist:<artifact>`` span and charges the session's
    ledger from the pass registry (``obs.ledger.HOIST_PASSES`` /
    ``FEATURE_HOIST_PASSES``). Unbound caches talk to the no-op
    singleton: no overhead, the same counters.
    """

    def __init__(self):
        self._store = {}
        self.hits = Counter()
        self.misses = Counter()
        self.obs = NULL_OBS
        self.n = 0
        self.pass_table = None

    def bind_obs(self, obs, n: int, table=None) -> "HoistCache":
        """Attach the observing session and the pass-table column
        (square- or feature-backed) that prices this cache's builds."""
        self.obs = obs
        self.n = n
        self.pass_table = table
        return self

    def get(self, key, build):
        """The cached value for ``key``, building (and counting a miss) on
        first use."""
        if key in self._store:
            self.hits[key] += 1
        else:
            self.misses[key] += 1
            art = key if isinstance(key, str) else key[0]
            with self.obs.span(f"hoist:{art}", phase="hoist",
                               key=str(key), n=self.n):
                self._store[key] = build()
            self.obs.charge_hoist(art, self.n, table=self.pass_table)
        return self._store[key]

    def counts(self, key) -> tuple:
        """(hits, misses) for one key."""
        return self.hits[key], self.misses[key]

    def build_count(self, artifact: str) -> int:
        """Total builds of an artifact family (every ("coords", ...) entry
        counts toward "coords")."""
        return sum(c for k, c in self.misses.items()
                   if (k if isinstance(k, str) else k[0]) == artifact)

    def keys(self):
        return self._store.keys()

    def __contains__(self, key):
        return key in self._store

    def __len__(self):
        return len(self._store)

    # -- resident-set accounting -------------------------------------------
    def nbytes(self, key=None) -> int:
        """Resident bytes of one cached artifact, or of the whole cache.

        With ``key=None`` the total counts each buffer once (the operator
        of a feature-backed session references the same condensed tensor
        the ``"condensed"`` entry stores); a per-key query counts that
        artifact's full reachable set. Unknown keys cost 0.
        """
        if key is not None:
            if key not in self._store:
                return 0
            return _resident_nbytes(self._store[key], set())
        return sum(self.nbytes_by_key().values())

    def nbytes_by_key(self) -> dict:
        """``{key: resident bytes}`` with shared buffers charged to the
        first key (insertion order) that reaches them, so the values sum
        to the total ``nbytes()`` returns."""
        seen: set = set()
        return {k: _resident_nbytes(v, seen)
                for k, v in self._store.items()}


def _resident_nbytes(value, seen: set) -> int:
    """Bytes of every tensor storage reachable from ``value``, walking
    dicts, sequences and dataclasses (``OrdinationResult``, the
    operators). A tensor is charged its whole storage, once: ``seen``
    holds each storage's (device, data pointer), so two views of one
    buffer, or two entries that share a tensor, count it once."""
    if value is None or isinstance(value, (bool, int, float, complex, str,
                                           bytes)):
        return 0
    if isinstance(value, torch.Tensor):
        storage = value.untyped_storage()
        ptr = (str(value.device), storage.data_ptr())
        if ptr in seen:
            return 0
        seen.add(ptr)
        return storage.nbytes()
    if id(value) in seen:
        return 0
    seen.add(id(value))
    if isinstance(value, dict):
        return sum(_resident_nbytes(v, seen) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(_resident_nbytes(v, seen) for v in value)
    if dataclasses.is_dataclass(value):
        return sum(_resident_nbytes(getattr(value, f.name), seen)
                   for f in dataclasses.fields(value))
    return 0


def _sketch_fingerprint(key, omega: Optional[torch.Tensor]):
    """Hashable identity of an fsvd sketch, for the ``coords`` key: a
    given ``omega`` by a digest of its fp32 values, else the int seed
    (``None``: the solver's default seed 42)."""
    if omega is not None:
        data = omega.detach().to("cpu", torch.float32).contiguous().numpy()
        return ("omega", hashlib.sha1(data.tobytes()).hexdigest())
    return DEFAULT_SEED if key is None else int(key)


class Workspace:
    """One distance matrix + one ExecConfig + a HoistCache = a session.

    ``dm`` may be a validated ``DistanceMatrix`` (trusted, paper §4.3) or
    a raw square array or tensor (validated here, once, unless
    ``validate=False``). The matrix is canonicalized to fp32 on
    ``config.device``; every analysis then serves off the shared cache.
    See the module docstring for the artifacts.
    """

    def __init__(self,
                 dm: Union[DistanceMatrix, torch.Tensor, np.ndarray,
                           None] = None,
                 config: Optional[ExecConfig] = None, validate: bool = True,
                 *, features=None, metric=None):
        self.config = config if config is not None else ExecConfig()
        # the requested config survives resolution, so refresh() (a new n)
        # re-solves from what was asked for, not from a previous solution
        self.config_requested = self.config
        self.tuned = None
        self.device = resolve_device(self.config.device)
        self.generation = 0
        self.cache = HoistCache()
        # the observing session rides the whole Workspace lifetime (spans
        # accumulate across refresh() generations); disabled, the shared
        # no-op singleton answers every span and charge
        self._obs = (ObsSession(self.config.obs)
                     if self.config.obs.enabled else NULL_OBS)
        if features is not None:
            if dm is not None:
                raise ValueError("pass a distance matrix OR a feature "
                                 "table, not both")
            self._admit_features(features, metric)
        else:
            if dm is None:
                raise ValueError("Workspace needs a distance matrix (or "
                                 "features= — see Workspace.from_features)")
            self._admit_dm(dm, validate)
        self._resolve_config()
        self._bind_cache()

    @classmethod
    def from_features(cls, features, metric=None,
                      config: Optional[ExecConfig] = None) -> "Workspace":
        """A session straight from an (n, d) feature table.

        The distances are produced panel by panel in condensed layout on
        first use, with the operator means and the Mantel moments taken
        from the same sweep, so the whole battery (``pcoa`` fsvd,
        ``permanova``, ``permdisp``, ``anosim``, ``mantel``,
        ``partial_mantel``) runs with no n×n matrix. ``metric`` is a
        ``repro_torch.dist`` name or ``Metric`` (default
        ``config.metric``, Bray–Curtis). The table is checked finite and
        made fp32 on ``config.device``.
        """
        return cls(features=features, metric=metric, config=config)

    # -- admission (shared by __init__ and refresh) -------------------------
    def _admit_dm(self, dm, validate: bool) -> None:
        given = dm if isinstance(dm, DistanceMatrix) else None
        source = given.data if given is not None else torch.as_tensor(dm)
        data = source.to(device=self.device, dtype=torch.float32)
        # finite first: a NaN would otherwise surface as "matrix is not
        # symmetric" (NaN != NaN), or with validate=False pass silently
        # into the eigenvalues
        ensure_finite(data)
        ids = given.ids if given is not None else None
        if given is not None and data is given.data and given._validated:
            self._dm = given
        elif validate and not (given is not None and given._validated):
            # one fused check on the session's device; an unvalidated
            # DistanceMatrix is not trusted for its type
            self._dm = DistanceMatrix(data, ids=ids, validate=True,
                                      device=self.device)
        else:
            # trusted: by the source's own cached validation, or by an
            # explicit validate=False
            self._dm = DistanceMatrix(data, ids=ids, _skip_validation=True,
                                      device=self.device)
        self._features = None
        self._metric = None
        self.n = len(self._dm)

    def _admit_features(self, features, metric) -> None:
        x = torch.as_tensor(features).to(device=self.device,
                                         dtype=torch.float32)
        if x.ndim != 2:
            raise ValueError(f"expected an (n, d) feature table, "
                             f"got shape {tuple(x.shape)}")
        ensure_finite(x, what="feature table")
        self._features = x.contiguous()
        self._metric = get_metric(metric if metric is not None
                                  else self.config.metric)
        self._dm = None
        self.n = int(x.shape[0])

    # -- cache lifecycle ----------------------------------------------------
    def refresh(self, dm=None, *, features=None, metric=None) -> "Workspace":
        """Drop every cached hoist and bump ``generation``.

        The cache assumes the session's data never change under it; when
        they do (the caller mutated the source buffer, or re-points the
        session at new data), ``refresh`` is the way back: every artifact
        goes, with fresh counters, and the next analysis re-runs each
        hoist once. ``dm=`` or ``features=`` re-admit new data (same
        validation as construction); with neither the data are kept and
        only the caches drop. Returns ``self``.
        """
        if dm is not None and features is not None:
            raise ValueError("pass a distance matrix OR a feature table, "
                             "not both")
        self.generation += 1
        self.cache = HoistCache()
        if dm is not None:
            self._admit_dm(dm, validate=True)
        elif features is not None:
            self._admit_features(features,
                                 metric if metric is not None
                                 else self._metric)
        elif self._features is not None:
            # feature-backed: a square built from the dropped production
            # goes with it
            self._dm = None
        self._resolve_config()
        self._bind_cache()
        return self

    def _resolve_config(self) -> None:
        """Resolve the requested config's auto knobs against the admitted
        data's (n, d) through ``repro_torch.tune``: ``config`` is concrete
        after admission, ``tuned`` the solver's record (``None`` when
        nothing asked for tuning)."""
        d = (int(self._features.shape[1]) if self._features is not None
             else None)
        self.config, self.tuned = self.config_requested.resolve(self.n, d)

    def _bind_cache(self) -> None:
        """Point the (fresh) HoistCache at the session's observability
        state and the pass-table column matching the current backing."""
        self.cache.bind_obs(
            self._obs, self.n,
            FEATURE_HOIST_PASSES if self._features is not None
            else HOIST_PASSES)

    # -- observability -------------------------------------------------------
    @property
    def obs(self):
        """The session's ``ObsSession``, or the shared no-op singleton
        when ``config.obs.enabled`` is False."""
        return self._obs

    def resolved_tiles(self) -> dict:
        """The geometry this session runs, as opposed to the knob values
        ``config`` carries (the reference reports Pallas's executed
        blocks here), as the launch modules state it. On the card:
        ``permute_reduce`` runs a tile of B permutations in slabs of
        ``permute_reduce_perms_per_launch`` on
        ``permute_reduce_resident_blocks`` blocks, for S = 1 (Mantel,
        ANOSIM) and S = 2 (partial Mantel); ``center_matvec`` sweeps
        strips of ``center_matvec_strip_rows`` output rows and takes up to
        ``center_matvec_max_columns`` columns a launch. On the CPU the
        plain ``permute_reduce`` walks the condensed stream in chunks of
        ``permute_reduce_plain_chunk``. A feature-backed session's
        production runs panels of ``production_panel_rows`` rows by the
        route ``production_route`` names (``dist.driver.production_route``
        on the session's table); on the CPU those panels are also the
        condensed operator's strips; on the card its product sweeps
        strips of ``condensed_matvec_strip_rows`` rows with clusters of
        ``condensed_matvec_split`` blocks at pcoa's sketch width."""
        b = self.config.resolve_batch_size(None, WORKSPACE_BATCH)
        features = self._features is not None
        tiles = {"device": self.device.type, "batch_size": b,
                 "auto": self.tuned is not None,
                 "production_panel_rows": (
                     clamp_block(self.n, self.config.block)
                     if features else None)}
        if features:
            route = production_route(self._features, self._metric)
            tiles["production_route"] = {
                "route": route.route, "nonzero_share": route.share,
                "nnz": route.nnz, "max_row": route.max_row}
        if self.device.type == "cuda":
            from repro_torch.kernels import (center_matvec, condensed_matvec,
                                             permute_reduce)
            per_launch = {s: permute_reduce.perms_per_launch(s, b)
                          for s in (1, 2)}
            tiles.update({
                "permute_reduce_perms_per_launch": {
                    f"S={s}": p for s, p in per_launch.items()},
                "permute_reduce_launches_per_tile": {
                    f"S={s}": -(-b // p) for s, p in per_launch.items()},
                "permute_reduce_resident_blocks": {
                    f"S={s}": (permute_reduce.resident_blocks(self.n, s, p)
                               if self.n >= 2 else 0)
                    for s, p in per_launch.items()}})
            square = center_matvec.geometry(self.n, self.n, 1)
            tiles.update(center_matvec_strip_rows=square["strip_rows"],
                         center_matvec_max_columns=square["max_columns"])
            if features:        # at pcoa's sketch of its default 10 dims
                product = condensed_matvec.geometry(self.n,
                                                    sketch_width(10, self.n))
                tiles.update(condensed_matvec_strip_rows=product["strip_rows"],
                             condensed_matvec_split=product["split"])
        else:
            from repro_torch.kernels.dispatch import snap_chunk
            from repro_torch.kernels.permute_reduce_ops import DEFAULT_CHUNK
            tiles["permute_reduce_plain_chunk"] = snap_chunk(
                condensed_size(self.n), DEFAULT_CHUNK)[0]
        return tiles

    def report(self, meta: Optional[dict] = None) -> RunReport:
        """The session's ``RunReport``: span tree, ledger totals, cache
        counters and resident bytes, the call sentinel's deltas for this
        session's window, and the geometry it ran
        (``resolved_tiles``), with the tuner's record under ``"tune"``
        when the config was auto-solved. With observability enabled and
        ``ObsConfig.probe`` set (the default), ``measured`` holds one
        ``obs.probe`` record a program the session runs, measured by one
        call on the session's device, and ``drift`` the ``obs.drift``
        verdicts on them; otherwise both are ``{}``. A probe perturbs
        nothing the report reads: no span, ledger charge, sentinel call,
        cache hit or launch count. With observability disabled the report
        still carries the cache counters and the sentinel's process
        snapshot, with empty spans and ledger."""
        by_key = self.cache.nbytes_by_key()
        base = {"n": self.n, "generation": self.generation,
                "backing": ("features" if self._features is not None
                            else "distance_matrix"),
                "device": str(self.device),
                "obs_enabled": self._obs.enabled,
                "tiles": self.resolved_tiles(),
                "cache_nbytes": {"total": sum(by_key.values()),
                                 "by_key": {str(k): v
                                            for k, v in by_key.items()}}}
        if self.tuned is not None:
            base["tune"] = self.tuned.to_dict()
        if meta:
            base.update(meta)
        measured = drift = None
        if self._obs.enabled and self.config.obs.probe:
            from repro_torch.obs.drift import DriftSentinel
            from repro_torch.obs.probe import probe_session
            measured = probe_session(self)
            drift = DriftSentinel(backend=self.device.type).reconcile(
                measured)
        return build_report(self._obs if self._obs.enabled else None,
                            cache=self.cache, meta=base,
                            measured=measured, drift=drift)

    # -- canonical views ----------------------------------------------------
    @property
    def dm(self) -> DistanceMatrix:
        """The session's square DistanceMatrix. A feature-backed session
        builds the n×n square from the condensed production on first
        access (cache key ``"square"``); no analysis asks for it."""
        if self._dm is None:
            square = self.cache.get("square", lambda: condensed_to_square(
                self.condensed(), self.n))
            self._dm = DistanceMatrix(square, _skip_validation=True,
                                      device=self.device)
        return self._dm

    @property
    def data(self) -> torch.Tensor:
        return self.dm.data

    # -- shared hoisted artifacts -------------------------------------------
    def _produce_distances(self) -> None:
        """Run the production (feature-backed sessions only): one sweep
        over the table builds both ``"condensed"`` and ``"dist_means"``
        (the operator means and the Mantel moments), which miss together
        by construction."""
        if "condensed" in self.cache and "dist_means" in self.cache:
            return
        with self._obs.span("ws.produce_distances", phase="production",
                            n=self.n, d=int(self._features.shape[1]),
                            metric=self._metric.name):
            prod = pairwise_condensed(self._features, self._metric,
                                      block=self.config.block,
                                      device=self.device)
        self.cache.get("condensed", lambda: prod["condensed"])
        self.cache.get("dist_means", lambda: {
            k: prod[k] for k in ("row_means", "global_mean", "mean",
                                 "norm")})

    def condensed(self) -> torch.Tensor:
        """The condensed (scipy ``pdist`` layout) distances: produced
        panel by panel for a feature-backed session, extracted from the
        square once otherwise."""
        if self._features is not None:
            self._produce_distances()
            return self.cache.get("condensed", lambda: None)
        return self.cache.get("condensed",
                              lambda: self._dm.condensed_form())

    def operator(self):
        """The matrix-free centred-Gram operator: the means of
        E = −½D∘D hoisted in one read of D, or for a feature-backed
        session taken from the production sweep and served over the
        condensed storage."""
        if self._features is not None:
            def build():
                self._produce_distances()
                means = self.cache.get("dist_means", lambda: None)
                return CondensedCenteredGramOperator(
                    self.cache.get("condensed", lambda: None),
                    means["row_means"], means["global_mean"], self.n,
                    self.config.block)
            return self.cache.get("operator", build)
        return self.cache.get("operator", lambda: (
            CenteredGramOperator.from_distance(self.data)))

    def gram(self) -> torch.Tensor:
        """The materialized Gower-centred matrix (PERMANOVA's hoist; the
        eigh and materialized solves), by ``config.centering_impl``."""
        return self.cache.get("gram", lambda: materialized_gram(
            self.data, self.config.centering_impl, self.config.mesh))

    def ranks(self) -> dict:
        """ANOSIM's rank transform of the shared ``"condensed"`` artifact:
        the sort runs once, and the ranks stay condensed."""
        return self.cache.get("ranks", lambda: rank_transform_condensed(
            self.condensed()))

    def moments(self) -> dict:
        """Condensed normalization moments: the centred norm (the permuted
        side of a Mantel test) and the centred-normalized ``hat`` vector
        (a fixed side). A feature-backed session takes the production's
        fused mean and norm and pays only the one O(m) pass for ``hat``."""
        if self._features is not None:
            def build():
                self._produce_distances()
                means = self.cache.get("dist_means", lambda: None)
                return {"norm": means["norm"],
                        "hat": (self.cache.get("condensed", lambda: None)
                                - means["mean"]) / means["norm"]}
            return self.cache.get("moments", build)
        return self.cache.get("moments", lambda: condensed_moments_vec(
            self.condensed()))

    # -- analyses -----------------------------------------------------------
    def pcoa(self, dimensions: int = 10, method: str = "fsvd",
             key: Union[int, torch.Generator, None] = None,
             omega: Optional[torch.Tensor] = None) -> OrdinationResult:
        """Principal Coordinates Analysis off the cached operator or gram.

        Whole results are cached per (dimensions, method, sketch), so
        ``permdisp`` reuses the coordinates an earlier ``pcoa`` produced.
        The sketch is fingerprinted by its seed (an int; ``None`` is the
        default seed 42) or, for a given ``omega``, by its values. A
        ``torch.Generator`` key is never cached: its draw depends on its
        state, which each solve advances, so a cached entry would hand a
        later call with the same object an earlier draw's coordinates;
        each such call solves afresh, as the free ``pcoa`` does. An eigh
        request for k dimensions is served by slicing a cached higher-k
        eigh solution (exactly what a direct solve returns), counted as a
        hit on that entry.
        """
        k = resolve_dimensions(dimensions, self.n)
        uncached = (method == "fsvd" and omega is None
                    and isinstance(key, torch.Generator))
        fp = (_sketch_fingerprint(key, omega)
              if method == "fsvd" and not uncached else None)
        cache_key = ("coords", k, method, fp)

        def build():
            if method == "eigh" or (method == "fsvd"
                                    and self.config.materialize):
                return _pcoa(self.dm, dimensions=k, method=method, key=key,
                             omega=omega, config=self.config,
                             check_finite=False, gram=self.gram())
            # matrix-free; a feature-backed session passes dm=None and
            # solves off the condensed operator alone, except through the
            # distributed matvec, which needs the square (its trace comes
            # off the operator's means)
            dm = self.dm if self.config.centering_impl == "distributed" \
                else self._dm
            return _pcoa(dm, dimensions=k, method=method, key=key,
                         omega=omega, config=self.config,
                         check_finite=False, operator=self.operator())

        if method == "eigh" and cache_key not in self.cache:
            cands = [kk for kk in self.cache.keys()
                     if isinstance(kk, tuple) and kk[0] == "coords"
                     and kk[2] == "eigh" and kk[1] >= k]
            if cands:
                src = min(cands, key=lambda kk: kk[1])
                full = self.cache.get(src, lambda: None)  # reuse: a hit

                def build():    # noqa: F811 — slice, don't re-solve
                    return OrdinationResult(
                        coordinates=full.coordinates[:, :k],
                        eigenvalues=full.eigenvalues[:k],
                        proportion_explained=full.proportion_explained[:k],
                        method="eigh", key=None)

        with self._obs.span("ws.pcoa", n=self.n, dimensions=k,
                            method=method):
            if uncached:
                return build()
            return self.cache.get(cache_key, build)

    # -- statistic construction (the serve seam) -----------------------------
    def statistic(self, method: str, *, grouping=None, other=None,
                  control=None, dimensions: Optional[int] = None,
                  pcoa_method: str = "fsvd",
                  omega: Optional[torch.Tensor] = None):
        """Build the hoisted ``(statistic, default_alternative)`` pair of
        one permutation test without running its loop: the statistic
        carries every cached hoist, and the caller drives the loop
        (``engine.permutation_test``, or ``hoist_and_observe`` and
        ``tile_statistics`` tile by tile). ``default_alternative`` is
        "greater" for the grouping tests and "two-sided" for the Mantel
        family. ``omega`` reaches PERMDISP's ordination (a test seam).
        """
        if method == "permanova":
            # a feature-backed session runs the OPERATOR form: neither the
            # square D nor the square Gower matrix is built
            # (config.materialize=True restores the materialized form)
            codes, num_groups = self._codes(grouping)
            if self._features is not None and not self.config.materialize:
                return PermanovaOperatorStatistic(
                    self.operator(), codes, self.n, num_groups), "greater"
            return PermanovaStatistic(self.data, codes, self.n, num_groups,
                                      pre={"g": self.gram()}), "greater"
        if method == "anosim":
            codes, num_groups = self._codes(grouping)
            return AnosimStatistic(None, codes, self.n, num_groups,
                                   pre=self.ranks()), "greater"
        if method == "permdisp":
            codes, num_groups = self._codes(grouping)
            dims = resolve_dimensions(dimensions, self.n)
            coords = self.pcoa(dimensions=dims, method=pcoa_method,
                               omega=omega).coordinates
            return PermdispStatistic(coords, codes, self.n,
                                     num_groups), "greater"
        if method == "mantel":
            y = self._coerce(other)
            if y.n != self.n:
                raise ValueError("x and y must have the same shape")
            pre = {"normxm": self.moments()["norm"],
                   "ynorm": y.moments()["hat"]}
            return MantelStatistic(self.condensed(), None, self.n,
                                   pre=pre), "two-sided"
        if method == "partial_mantel":
            y, z = self._coerce(other), self._coerce(control)
            if not (self.n == y.n == z.n):
                raise ValueError("x, y and z must have the same shape")
            pre = _residualize(y.moments()["hat"], z.moments()["hat"])
            # checked eagerly: |r_yz| -> 1 makes the residualization 0/0
            # and NaNs the whole null distribution
            r = float(pre["r_yz"])
            if 1.0 - r * r < COLLINEAR_TOL:
                raise ValueError(
                    f"y and z are (nearly) collinear (r_yz={r:.6f}); the "
                    f"partial correlation is undefined — use the plain "
                    f"Mantel test")
            pre["normxm"] = self.moments()["norm"]
            cls = (PartialMantelPallasStatistic
                   if self.config.kernel == "pallas"
                   else PartialMantelStatistic)
            return cls(self.condensed(), None, None, self.n,
                       pre=pre), "two-sided"
        raise ValueError(
            f"unknown method {method!r}; expected one of ('permanova', "
            f"'anosim', 'permdisp', 'mantel', 'partial_mantel')")

    def _run(self, method: str, stat, permutations: int, key, alternative,
             batch_size, orders) -> PermutationTestResult:
        return engine.permutation_test(
            stat, permutations, key, alternative=alternative,
            batch_size=self.config.resolve_batch_size(batch_size,
                                                      WORKSPACE_BATCH),
            orders=orders, method=method, device=self.device,
            config=self.config)

    def permanova(self, grouping, permutations: int = 999,
                  key: Union[int, torch.Generator, None] = None,
                  batch_size: Optional[int] = None,
                  orders: Optional[torch.Tensor] = None
                  ) -> PermutationTestResult:
        """PERMANOVA off the cached Gower centering (one-sided, greater);
        a feature-backed session runs the operator form over the
        condensed storage."""
        with self._obs.span("ws.permanova", n=self.n,
                            permutations=permutations):
            stat, alt = self.statistic("permanova", grouping=grouping)
            return self._run("permanova", stat, permutations, key, alt,
                             batch_size, orders)

    def anosim(self, grouping, permutations: int = 999,
               key: Union[int, torch.Generator, None] = None,
               batch_size: Optional[int] = None,
               orders: Optional[torch.Tensor] = None
               ) -> PermutationTestResult:
        """ANOSIM off the cached condensed ranks (one-sided, greater)."""
        with self._obs.span("ws.anosim", n=self.n,
                            permutations=permutations,
                            kernel=self.config.kernel):
            stat, alt = self.statistic("anosim", grouping=grouping)
            return self._run("anosim", stat, permutations, key, alt,
                             batch_size, orders)

    def permdisp(self, grouping, permutations: int = 999,
                 key: Union[int, torch.Generator, None] = None,
                 dimensions: Optional[int] = None, method: str = "fsvd",
                 batch_size: Optional[int] = None,
                 orders: Optional[torch.Tensor] = None,
                 omega: Optional[torch.Tensor] = None
                 ) -> PermutationTestResult:
        """PERMDISP off the cached ordination (one-sided, greater): the
        coordinates are shared with ``ws.pcoa`` at matching (dimensions,
        method, sketch), so the ordination runs at most once a session.
        ``key`` drives only the permutation orders."""
        dims = resolve_dimensions(dimensions, self.n)
        with self._obs.span("ws.permdisp", n=self.n,
                            permutations=permutations, dimensions=dims):
            stat, alt = self.statistic("permdisp", grouping=grouping,
                                       dimensions=dims, pcoa_method=method,
                                       omega=omega)
            return self._run("permdisp", stat, permutations, key, alt,
                             batch_size, orders)

    def mantel(self, other, permutations: int = 999,
               key: Union[int, torch.Generator, None] = None,
               alternative: str = "two-sided",
               batch_size: Optional[int] = None,
               orders: Optional[torch.Tensor] = None
               ) -> PermutationTestResult:
        """Mantel test of this matrix (permuted) against ``other`` (a
        Workspace, DistanceMatrix or raw array; held fixed). Square-free:
        the permuted side is the shared condensed artifact, the fixed
        side contributes its condensed ``hat`` vector."""
        with self._obs.span("ws.mantel", n=self.n,
                            permutations=permutations,
                            kernel=self.config.kernel):
            stat, _ = self.statistic("mantel", other=other)
            return self._run("mantel", stat, permutations, key, alternative,
                             batch_size, orders)

    def partial_mantel(self, other, control, permutations: int = 999,
                       key: Union[int, torch.Generator, None] = None,
                       alternative: str = "two-sided",
                       batch_size: Optional[int] = None,
                       orders: Optional[torch.Tensor] = None
                       ) -> PermutationTestResult:
        """Partial Mantel of this matrix against ``other``, controlling
        for ``control``; ŷ is residualized from the cached moments, and
        all three operands stay condensed. Each tile is one S = 2
        ``permute_reduce`` on the card, whatever ``config.kernel`` says."""
        with self._obs.span("ws.partial_mantel", n=self.n,
                            permutations=permutations,
                            kernel=self.config.kernel):
            stat, _ = self.statistic("partial_mantel", other=other,
                                     control=control)
            return self._run("partial_mantel", stat, permutations, key,
                             alternative, batch_size, orders)

    # -- plumbing -----------------------------------------------------------
    def _codes(self, grouping):
        return engine.grouping_codes(grouping, self.n, self.device)

    def _coerce(self, other) -> "Workspace":
        """Other operands join the session: a Workspace keeps its own
        cache (and must lie on this session's device); anything else gets
        a one-shot Workspace on this session's config. A DistanceMatrix's
        validation status is trusted as constructed (paper §4.3); raw
        arrays are validated on admission."""
        if isinstance(other, Workspace):
            if other.device.type != self.device.type:
                raise ValueError(f"the other session lies on "
                                 f"{other.device}, not on {self.device}")
            return other
        return Workspace(other, config=self.config,
                         validate=not isinstance(other, DistanceMatrix))

    def __repr__(self):
        return (f"Workspace(n={self.n}, "
                f"cached={sorted(map(str, self.cache.keys()))}, "
                f"config={self.config})")
