"""Logical-axis → mesh-axis sharding rules.

The counterpart of ``repro/sharding/rules.py``, with its layout on the
production mesh (pod?, data, model):

* **DP**   — batch over ("pod", "data");
* **FSDP** — weight and optimizer-state sharding over the same DP axes
  (ZeRO-3: gathered at use, the gradient reduce-scattered);
* **TP**   — heads / d_ff / experts / vocab / recurrent channels over
  "model";
* **EP**   — MoE experts over "model" when E divides it (granite, 32
  experts); otherwise over each expert FFN's hidden dim (grok, 8);
* **SP**   — decode caches deeper than 4096 slots shard their sequence
  over "model".

A spec (``PartitionSpec``) is the reference's: one entry a tensor dim,
each ``None``, one axis name, or a tuple of axes such as ``("pod",
"data")`` (the first outermost). Every rule fits an axis only when the
dim divides it (``_fit``), so no padding is ever introduced.

The port holds one module a layer (``blocks.{i}.…``), where the reference
stacks each pattern position's layers for its scan; a stacked leaf's spec
``P(None, *s)`` there is ``s`` on each of the port's per-layer leaves here.
The rules read only axis names and sizes, so they run on an
``AbstractMesh`` (shape and names, no ranks) as on a ``DeviceMesh``:
the specs of the (16, 16) and (2, 16, 16) production meshes are computed
without 256 processes. ``named`` turns a spec into a ``DTensor``'s
placements on a real mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.launch.mesh import placements


class PartitionSpec(tuple):
    """``P("data", None, "model")``: one entry a tensor dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, with no ranks behind it (the
    counterpart of ``jax.sharding.AbstractMesh``)."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.axis_sizes} and axes "
                             f"{self.axis_names} differ in length")

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return self.axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    def size(self, dim: Optional[int] = None) -> int:
        return (math.prod(self.axis_sizes) if dim is None
                else self.axis_sizes[dim])


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or an ``AbstractMesh``."""
    names = mesh.mesh_dim_names
    return {a: mesh.size(i) for i, a in enumerate(names)}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: object                 # a DeviceMesh or an AbstractMesh
    dp: Tuple[str, ...]          # batch axes, e.g. ("pod", "data")
    fsdp: Tuple[str, ...]        # weight-sharding axes
    tp: str = "model"

    def axis_size(self, axes) -> int:
        if isinstance(axes, str):
            axes = (axes,)
        sizes = mesh_shape(self.mesh)
        return math.prod(sizes[a] for a in axes) if axes else 1


def make_rules(mesh, fsdp: bool = True) -> ShardingRules:
    """fsdp=True → ZeRO-3 weight sharding over the DP axes (memory-min);
    fsdp=False → weights and moments replicated over DP, TP only (no
    gather of the weights at use, one gradient all-reduce)."""
    names = mesh.mesh_dim_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    return ShardingRules(mesh=mesh, dp=dp, fsdp=dp if fsdp else ())


def _fit(dim: int, axes, rules: ShardingRules):
    """The largest suffix of ``axes`` whose size divides ``dim``:
    ("pod", "data") → both, then "data", then None."""
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(axes)
    while axes:
        if dim % rules.axis_size(axes) == 0:
            return axes if len(axes) > 1 else axes[0]
        axes = axes[1:]
    return None


# --------------------------------------------------------------------------
# parameter rules
# --------------------------------------------------------------------------
def _param_spec(name: str, shape, cfg, rules: ShardingRules) -> P:
    tp, fsdp = rules.tp, rules.fsdp
    nd = len(shape)
    leaf = name.rsplit(".", 1)[-1]

    if leaf in ("table", "head"):                       # (V, D)
        return P(_fit(shape[0], tp, rules), _fit(shape[1], fsdp, rules))
    if leaf in ("wq", "wk", "wv"):                      # (D, H, hd)
        return P(_fit(shape[0], fsdp, rules), _fit(shape[1], tp, rules),
                 None)
    if leaf == "wo":                                    # (H, hd, D)
        return P(_fit(shape[0], tp, rules), None,
                 _fit(shape[2], fsdp, rules))
    if leaf in ("bq", "bk", "bv"):                      # (H, hd)
        return P(_fit(shape[0], tp, rules), None)
    if leaf in ("w_gate", "w_up"):
        if nd == 3:                                     # (E, D, F) MoE
            e_ax = _fit(shape[0], tp, rules)
            f_ax = None if e_ax else _fit(shape[2], tp, rules)
            return P(e_ax, _fit(shape[1], fsdp, rules), f_ax)
        return P(_fit(shape[0], fsdp, rules), _fit(shape[1], tp, rules))
    if leaf == "w_down":
        if nd == 3:                                     # (E, F, D) MoE
            e_ax = _fit(shape[0], tp, rules)
            f_ax = None if e_ax else _fit(shape[1], tp, rules)
            return P(e_ax, f_ax, _fit(shape[2], fsdp, rules))
        return P(_fit(shape[0], tp, rules), _fit(shape[1], fsdp, rules))
    if leaf == "router":                                # (D, E) fp32
        return P(_fit(shape[0], fsdp, rules), None)
    # recurrent block
    if leaf in ("w_gate_branch", "w_rec_branch"):       # (D, R)
        return P(_fit(shape[0], fsdp, rules), _fit(shape[1], tp, rules))
    if leaf in ("w_a", "w_x") and nd == 2 and shape[0] == shape[1]:
        return P(_fit(shape[0], fsdp, rules), _fit(shape[1], tp, rules))
    if leaf in ("b_a", "b_x", "lambda"):                # (R,)
        return P(_fit(shape[0], tp, rules))
    if leaf == "w_out":                                 # (R|di, D)
        return P(_fit(shape[0], tp, rules), _fit(shape[1], fsdp, rules))
    # ssd block
    if leaf in ("w_x", "w_z"):                          # (D, di)
        return P(_fit(shape[0], fsdp, rules), _fit(shape[1], tp, rules))
    if leaf in ("w_b", "w_c"):                          # (D, g*N): replicated
        return P(_fit(shape[0], fsdp, rules), None)
    if leaf == "w_dt":                                  # (D, nh)
        return P(_fit(shape[0], fsdp, rules), _fit(shape[1], tp, rules))
    if leaf in ("dt_bias", "a_log", "d_skip"):          # (nh,)
        return P(_fit(shape[0], tp, rules))
    if leaf == "conv_w":                                # (W, channels)
        return P(None, _fit(shape[1], tp, rules))
    if leaf == "norm_w":                                # (di,)
        return P(_fit(shape[0], tp, rules))
    if leaf == "proj":                                  # frontend (fd, D)
        return P(None, _fit(shape[1], fsdp, rules))
    # norms / scalars / anything small: replicated
    return P(*([None] * nd))


def _named_shapes(params) -> dict:
    if isinstance(params, nn.Module):
        return {k: tuple(p.shape) for k, p in params.named_parameters()}
    return {k: tuple(v.shape) for k, v in params.items()}


def param_specs(cfg, params, rules: ShardingRules) -> dict:
    """``{name: P}`` for a model's parameters (a module, on ``meta``
    too, or a ``{name: tensor}`` mapping), from the global shapes."""
    return {name: _param_spec(name, shape, cfg, rules)
            for name, shape in _named_shapes(params).items()}


# --------------------------------------------------------------------------
# cache rules (decode/prefill state)
# --------------------------------------------------------------------------
def _cache_spec(name: str, shape, cfg, rules: ShardingRules) -> P:
    dp, tp = rules.dp, rules.tp
    leaf = name.rsplit(".", 1)[-1]
    nd = len(shape)
    if leaf in ("k", "v", "cross_k", "cross_v"):        # (B, S, K, hd)
        b_ax = _fit(shape[0], dp, rules)
        # SP: sequence over "model"; rings (local windows) stay whole
        s_ax = _fit(shape[1], tp, rules) if shape[1] > 4096 else None
        k_ax = None if s_ax else _fit(shape[2], tp, rules)
        return P(b_ax, s_ax, k_ax, None)
    if leaf in ("k_scale", "v_scale"):                  # (B, S, K)
        b_ax = _fit(shape[0], dp, rules)
        s_ax = _fit(shape[1], tp, rules) if shape[1] > 4096 else None
        return P(b_ax, s_ax, None)
    if leaf == "pos" and nd == 1:
        return P(None)
    if leaf == "conv":                                  # (B, W-1, channels)
        return P(_fit(shape[0], dp, rules), None, _fit(shape[2], tp, rules))
    if leaf == "h":
        if nd == 2:                                     # rec state (B, R)
            return P(_fit(shape[0], dp, rules), _fit(shape[1], tp, rules))
        if nd == 4:                                     # ssd state (B,nh,N,hd)
            return P(_fit(shape[0], dp, rules), _fit(shape[1], tp, rules),
                     None, None)
    return P(*([None] * nd))


def cache_leaves(cache) -> list:
    """``(name, holder, field)`` of every tensor of an ``LMCache`` or
    ``EncDecCache``, in order: ``getattr(holder, field)`` is the tensor,
    ``name`` its path (``blocks.3.k``, ``dec.0.self_attn.pos``,
    ``dec.0.cross_k``)."""
    out = []

    def walk(obj, prefix):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor):
                out.append((f"{prefix}{f.name}", obj, f.name))
            elif dataclasses.is_dataclass(v):
                walk(v, f"{prefix}{f.name}.")
            elif isinstance(v, list):
                for i, item in enumerate(v):
                    walk(item, f"{prefix}{f.name}.{i}.")

    walk(cache, "")
    return out


def cache_specs(cfg, cache, rules: ShardingRules) -> dict:
    """``{name: P}`` for the tensors of a cache (``cache_leaves``' names);
    the host-int position needs none."""
    return {name: _cache_spec(name, tuple(getattr(obj, f).shape), cfg,
                              rules)
            for name, obj, f in cache_leaves(cache)}


# --------------------------------------------------------------------------
# batch / activation rules
# --------------------------------------------------------------------------
def batch_spec(rules: ShardingRules, batch: int, rank: int = 2) -> P:
    """Tokens/targets (B, S): batch over the DP axes that divide it."""
    return P(_fit(batch, rules.dp, rules), *([None] * (rank - 1)))


def logits_spec(rules: ShardingRules, batch: int, vocab: int) -> P:
    return P(_fit(batch, rules.dp, rules), None, _fit(vocab, rules.tp, rules))


def spec_axes(entry) -> Tuple[str, ...]:
    """The axes of one spec entry, outermost first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def named(mesh, spec):
    """A spec's ``DTensor`` placements on ``mesh`` (a ``{name: P}`` mapping
    → the same mapping of placements): ``Shard(d)`` on the axes of dim d,
    ``Replicate()`` on the others; a dim over several axes is split
    outermost-first, as ``DTensor`` orders a dim's mesh axes."""
    if isinstance(spec, Mapping):
        return {k: named(mesh, s) for k, s in spec.items()}
    shards = {}
    for dim, entry in enumerate(spec):
        for a in spec_axes(entry):
            if a in shards:
                raise ValueError(f"axis {a!r} shards two dims of {spec}")
            shards[a] = dim
    order = [a for a in mesh.mesh_dim_names if a in shards]
    for entry in spec:
        axes = [a for a in order if a in spec_axes(entry)]
        if axes != list(spec_axes(entry)):
            raise ValueError(f"{spec}: a dim's axes must follow the mesh's "
                             f"order {mesh.mesh_dim_names}")
    return placements(mesh, shards)


# --------------------------------------------------------------------------
# placement: each rank keeps the block its spec names
# --------------------------------------------------------------------------
def spec_dims(spec) -> dict:
    """``{dim: axes}`` of the sharded dims of a spec."""
    return {d: spec_axes(e) for d, e in enumerate(spec) if spec_axes(e)}


def from_block(local: torch.Tensor, mesh, spec, shape) -> DTensor:
    """The ``DTensor`` of global ``shape`` placed by ``spec`` whose block on
    this rank is ``local`` (``DTensor.from_local``, no communication)."""
    shape = torch.Size(shape)
    return DTensor.from_local(local, mesh, named(mesh, spec),
                              run_check=False, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def shard_tensor(full: torch.Tensor, mesh, spec) -> DTensor:
    """A ``DTensor`` placed by ``spec`` from a global tensor every rank
    holds: the rank keeps its block (no scatter from a root), a copy unless
    the block is the whole tensor. One already placed so is returned."""
    from repro_torch.launch.mesh import active_axes, local_of
    if isinstance(full, DTensor):
        if tuple(full.placements) != tuple(named(mesh, spec)):
            raise ValueError(f"a tensor placed {full.placements} where the "
                             f"spec {spec} wants {named(mesh, spec)}")
        return full
    dims = spec_dims(spec)
    local = full.detach()
    if any(active_axes(mesh, ax) for ax in dims.values()):
        local = local_of(local, mesh, dims).clone()
    return from_block(local, mesh, spec, full.shape)


def place_module(model: nn.Module, mesh, specs: Mapping) -> nn.Module:
    """``model`` with each parameter replaced, in place, by a ``DTensor``
    parameter placed by ``specs[name]`` (one already placed so is kept)."""
    for name, p in list(model.named_parameters()):
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        placed = shard_tensor(p if isinstance(p, DTensor) else p.data, mesh,
                              specs[name])
        if placed is not p:
            mod._parameters[attr] = nn.Parameter(
                placed, requires_grad=p.requires_grad)
    return model
