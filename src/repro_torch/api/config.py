"""ExecConfig: one home for every execution knob in the analysis stack.

The counterpart of ``repro/api/config.py``: a frozen dataclass (the port
has no pytrees) with the reference's field names, defaults and
validation, threaded through ``api.Workspace``, ``core.pcoa`` and
``stats.engine``. Two configs compare and hash equal iff every knob
matches, so a reference user's config carries across.

What the knobs mean here. The device decides the route: on the card
every path runs the hand-written CUDA kernels, on the CPU their plain
PyTorch versions, and nothing falls back from one to the other. Six
fields are accepted, validated as in the reference and then read by no
route of the port, so that a reference user's config carries across:
``matvec_impl``, ``pairwise_impl`` and ``kernel`` (each path has one
kernel; ``kernel="pallas"`` only names the partial-Mantel statistic
``PartialMantelPallasStatistic``, the same route), and ``interpret``,
``chunk`` and ``feature_block`` (Pallas dispatch and tiles; the CUDA
kernels own their geometry). ``centering_impl`` chooses the route of
the materialized Gower matrix: ``"ref"`` is the eager Algorithm 1 on the
CPU, ``"fused"`` the ``center`` pair's plain version there (on the card
both run the ``center`` kernel pair), and ``"distributed"`` centres over
``mesh`` (a ``torch.distributed`` ``DeviceMesh``, see
``repro_torch.launch.mesh``), where it also routes matrix-free PCoA
through the distributed matvec.
``block`` sets the production's row panels and the condensed operator's
strips, as in the reference, and changes nothing inside a kernel.

``auto=True``, ``tune_profile`` and every ``"auto"`` knob are resolved
by ``repro_torch.tune`` against the admitted data's (n, d): ``Workspace``
calls ``resolve(n, d)`` at admission. The budget is the config device's
(``None``: the card, whose solve follows the CUDA kernels' geometry;
``"cpu"``: the reference's CPU column, so the solve gives the
reference's tiles), or the ``tune_profile`` JSON.

This module imports nothing of ``repro_torch`` except ``obs.config`` (and
the tuner, lazily, in ``resolve``), so any layer can import it without
cycles.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

from repro_torch.obs.config import ObsConfig

# mirror of repro_torch.dist.METRICS, kept literal because this module
# imports nothing of the package (pinned in sync by tests/test_torch_api.py)
_KNOWN_METRICS = ("braycurtis", "canberra", "cityblock", "euclidean",
                  "jaccard")


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Execution configuration shared by every analysis entry point.

    Fields (the reference's; see the module docstring for what each
    does in the port)
    ------
    matvec_impl, pairwise_impl, kernel:
        ``"xla"`` (default) or ``"pallas"``. Read by no route: the
        operator matvec runs ``center_matvec``, the production
        ``pairwise_panel``, the condensed reductions of the Mantel family
        ``permute_reduce`` and ANOSIM's ``within_sums`` on the card, their
        plain versions on the CPU; ``kernel="pallas"`` names the partial-Mantel
        statistic ``PartialMantelPallasStatistic``, as in the reference.
    interpret, chunk, feature_block:
        The reference's Pallas dispatch mode (``None``, ``True`` or
        ``False``), condensed-stream chunk (``None``, ``"auto"`` or an
        int >= 1) and feature tile (``"auto"`` or an int >= 1, default
        128). Validated, resolved, read by no route.
    centering_impl:
        ``"ref"``, ``"fused"`` (default) or ``"distributed"`` for the
        materialized Gower matrix: the ``center`` kernel pair on the card
        for the first two, on the CPU the eager Algorithm 1 or the pair's
        plain version; ``"distributed"`` centres over ``mesh`` (and runs
        matrix-free PCoA through the distributed matvec). It requires a
        mesh.
    materialize:
        ``True`` runs PCoA through the materialized Gower matrix;
        ``False`` (default) matrix-free through the operator.
    block:
        An int >= 1 (default 256): the rows of a production panel and of
        a condensed-operator strip. ``"auto"``: solved shrink-only from
        the default, so auto keeps the default geometry whenever it fits.
    batch_size:
        Permutations per engine tile: an int >= 1, or ``None`` for each
        test's default (32). ``"auto"``: solved from (n, budget), never
        from K, so one padded per-batch program serves every K.
    mesh:
        Optional ``torch.distributed`` ``DeviceMesh`` for the distributed
        paths (``centering_impl="distributed"``), with the reference's
        axis names (``repro_torch.launch.mesh.make_host_mesh``). A
        session's permutation tests do not use it, as in the reference.
    device:
        Where a Workspace holds its data: ``None`` (default) is the card,
        ``"cpu"`` the CPU (the plain versions); a string or a
        ``torch.device`` of type cuda or cpu.
    metric:
        Default metric of ``Workspace.from_features``.
    auto:
        ``True`` turns every knob still at its default into ``"auto"``;
        knobs set to concrete values are honored.
    tune_profile:
        Optional path of a ``tune.save_profile`` JSON: auto-solving fits
        against that budget instead of the device's.
    obs:
        Observability switchboard (``repro_torch.obs.ObsConfig``);
        ``None`` coerces to the disabled default.
    """

    matvec_impl: str = "xla"
    centering_impl: str = "fused"
    materialize: bool = False
    interpret: Optional[bool] = None
    block: Union[int, str] = 256
    batch_size: Union[int, str, None] = None
    kernel: str = "xla"
    mesh: Optional[Any] = None
    device: Union[str, torch.device, None] = None
    metric: str = "braycurtis"
    pairwise_impl: str = "xla"
    feature_block: Union[int, str] = 128
    chunk: Union[int, str, None] = None
    auto: bool = False
    tune_profile: Optional[str] = None
    obs: Optional[ObsConfig] = ObsConfig()

    def __post_init__(self):
        if self.obs is None:
            object.__setattr__(self, "obs", ObsConfig())
        if not isinstance(self.obs, ObsConfig):
            raise ValueError(f"obs must be an ObsConfig (or None), "
                             f"got {self.obs!r}")
        if self.matvec_impl not in ("xla", "pallas"):
            raise ValueError(f"unknown matvec_impl {self.matvec_impl!r}")
        if self.centering_impl not in ("ref", "fused", "distributed"):
            raise ValueError(f"unknown centering_impl "
                             f"{self.centering_impl!r}")
        if self.kernel not in ("xla", "pallas"):
            raise ValueError(f"unknown kernel {self.kernel!r}")
        if self.centering_impl == "distributed" and self.mesh is None:
            raise ValueError("centering_impl='distributed' requires a mesh")
        for knob in ("block", "feature_block"):
            v = getattr(self, knob)
            if not (v == "auto" or (isinstance(v, int) and v >= 1)):
                raise ValueError(f"{knob} must be an int >= 1 or 'auto', "
                                 f"got {v!r}")
        for knob in ("batch_size", "chunk"):
            v = getattr(self, knob)
            if not (v is None or v == "auto"
                    or (isinstance(v, int) and v >= 1)):
                raise ValueError(f"{knob} must be an int >= 1, 'auto' or "
                                 f"None, got {v!r}")
        if self.metric not in _KNOWN_METRICS:
            raise ValueError(f"unknown metric {self.metric!r}; "
                             f"available: {list(_KNOWN_METRICS)}")
        if self.pairwise_impl not in ("xla", "pallas"):
            raise ValueError(f"unknown pairwise_impl "
                             f"{self.pairwise_impl!r}")
        if self.device is not None and \
                torch.device(self.device).type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device!r}")

    def replace(self, **changes) -> "ExecConfig":
        """A copy with ``changes`` applied (``dataclasses.replace``)."""
        return dataclasses.replace(self, **changes)

    def resolve_batch_size(self, explicit: Optional[int],
                           default: int) -> Union[int, str]:
        """Precedence: explicit call-site arg > config > per-test
        default. An unresolved ``"auto"`` falls through to the engine,
        which solves it against the statistic's n."""
        if explicit is not None:
            return explicit
        if self.batch_size is not None:
            return self.batch_size
        return default

    @property
    def needs_resolution(self) -> bool:
        """True when some knob still carries auto semantics, i.e.
        ``resolve()`` would change this config."""
        return bool(self.auto or "auto" in (self.block, self.feature_block,
                                            self.batch_size, self.chunk))

    def resolve(self, n: int, d: Optional[int] = None
                ) -> "tuple[ExecConfig, Optional[Any]]":
        """Materialize the auto knobs against a problem of n observations
        (and d features): ``(resolved_config, tuned)``, ``tuned`` the
        ``tune.TunedTiles`` record or ``None`` when nothing asked for
        tuning. The import is lazy, so a config that never opts in loads
        nothing of the tuner."""
        if not self.needs_resolution:
            return self, None
        from repro_torch.tune.solve import resolve_exec_config
        return resolve_exec_config(self, n, d)
