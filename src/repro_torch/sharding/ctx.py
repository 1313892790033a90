"""Activation-sharding context, and the weights gathered at use.

The counterpart of ``repro/sharding/ctx.py``. ``use_rules(rules)`` makes
the rules current while a step runs, so model code reaches them without a
parameter in every signature; with no rules set every function here is a
no-op, as there.

Each rank computes on its own rows of the batch (the step took them by
``batch_spec``), so ``constrain_batch`` and ``constrain``, which pin a
layout for GSPMD in the reference, hold here where the models call them
and move nothing: the rank's rows are already where the spec puts them.

What GSPMD does for the weights the port does by hand. A sharded step
registers each parameter's block (``use_shards``); ``gathered(module)``
puts the global weights of ``module``'s parameters in their place for the
duration of a block (``launch.mesh.gather_leaf``: differentiable, its
backward summing over the batch axes and keeping the rank's block), so a
block's weights are gathered when it runs, and again when a remat block
runs again in the backward. ``vocab_rows`` gathers a (V, D) table over
all but the TP axis: the embedding, the head and the loss work on the
rank's vocab slice and reduce over the TP axis (``tp_sum``,
``tp_gather``), so no rank gathers the whole table. ``batch_ranks`` and
``batch_sum`` carry the MoE load-balance statistics over the batch axes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.launch import mesh as mesh_mod

_CURRENT: Optional[object] = None      # ShardingRules
_SHARDS: Optional["Shards"] = None


@contextlib.contextmanager
def use_rules(rules):
    global _CURRENT
    prev = _CURRENT
    _CURRENT = rules
    try:
        yield
    finally:
        _CURRENT = prev


def current_rules():
    return _CURRENT


def constrain_batch(x: torch.Tensor, batch_dim: int = 0,
                    seq_dim: Optional[int] = None) -> torch.Tensor:
    """``x`` as it is: the rank holds its rows of ``batch_dim`` already."""
    return x


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """``x`` as it is (see ``constrain_batch``)."""
    return x


@dataclasses.dataclass
class Shards:
    """The blocks of a sharded model's parameters: ``leaves`` maps the
    ``id`` of each parameter (the ``DTensor`` the module holds) to
    ``(local, dims)``, the rank's block that takes the gradient and its
    ``{dim: axes}``; ``batch_axes`` are the axes the batch is split over."""
    mesh: object
    leaves: dict
    batch_axes: tuple = ()
    tp: str = "model"

    def __post_init__(self):
        # every axis of one rank: each weight is its block, nothing to do
        self.local_only = self.mesh.size() == 1


@contextlib.contextmanager
def use_shards(shards: Optional[Shards]):
    global _SHARDS
    prev = _SHARDS
    _SHARDS = shards
    try:
        yield
    finally:
        _SHARDS = prev


def current_shards() -> Optional[Shards]:
    return _SHARDS


@contextlib.contextmanager
def gathered(module):
    """``module``'s registered parameters replaced by their global weights
    while the context lasts (nothing to do without ``use_shards``)."""
    s = _SHARDS
    if s is None:
        yield
        return
    swapped = []
    try:
        for mod in module.modules():
            for attr, p in mod._parameters.items():
                entry = None if p is None else s.leaves.get(id(p))
                if entry is None:
                    continue
                local, dims = entry
                mod._parameters[attr] = local if s.local_only else \
                    mesh_mod.gather_leaf(local, s.mesh, dims, s.batch_axes)
                swapped.append((mod, attr, p))
        yield
    finally:
        for mod, attr, p in swapped:
            mod._parameters[attr] = p


@contextlib.contextmanager
def swapped(entries):
    """Each ``(holder, key, placed, local)`` of ``entries``: ``holder[key]``
    (a module's parameter dict, or a cache's ``vars``) holds ``local`` while
    the context lasts and ``placed`` again after. On a mesh of one rank a
    step swaps every block in once, in place of ``gathered`` and
    ``gathered_cache`` a layer."""
    for holder, key, _, local in entries:
        holder[key] = local
    try:
        yield
    finally:
        for holder, key, placed, _ in entries:
            holder[key] = placed


def holds(entries) -> bool:
    """Whether every holder of ``entries`` (``swapped``'s) still holds its
    placed tensor."""
    return all(holder.get(key) is placed for holder, key, placed, _ in entries)


def vocab_rows(module, attr: str) -> tuple:
    """``(rows, v0)``: ``module.<attr>`` (a (V, D) table) gathered over
    every axis but the TP axis, so the rank's vocab rows whole in D, and
    the index of their first row. The parameter itself and 0 without
    ``use_shards``, or where the TP axis does not split the vocab."""
    p = module._parameters[attr]
    s = _SHARDS
    entry = None if s is None else s.leaves.get(id(p))
    if entry is None:
        return p, 0
    local, dims = entry
    if s.local_only:
        return local, 0
    rest = {d: tuple(a for a in ax if a != s.tp) for d, ax in dims.items()}
    rows = mesh_mod.gather_leaf(local, s.mesh, rest, s.batch_axes)
    split = s.tp in dims.get(0, ()) and mesh_mod.active_axes(s.mesh, s.tp)
    return rows, (mesh_mod.axis_index(s.mesh, s.tp) * rows.shape[0]
                  if split else 0)


def tp_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the TP axis in rank order, its gradient passed as
    it is (``launch.mesh.reduce_from``); ``t`` without ``use_shards``."""
    s = _SHARDS
    return t if s is None else mesh_mod.reduce_from(t, s.mesh, s.tp)


def tp_gather(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' ``t`` of the TP axis concatenated on ``dim`` in rank
    order (no gradient); ``t`` without ``use_shards``."""
    s = _SHARDS
    return t if s is None else mesh_mod.gather_dims(t, s.mesh,
                                                    {dim: (s.tp,)})


def batch_ranks() -> int:
    """The ranks the batch is split over (1 without ``use_shards``)."""
    s = _SHARDS
    if s is None or not s.batch_axes:
        return 1
    return mesh_mod.axis_size(s.mesh, s.batch_axes)


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the batch axes in rank order, its gradient summed
    the same way (``launch.mesh.all_reduce``)."""
    s = _SHARDS
    if s is None or not s.batch_axes:
        return t
    return mesh_mod.all_reduce(t, s.mesh, s.batch_axes)


def at_use(fn):
    """``fn(module, *args)`` run with ``module``'s weights gathered (under
    ``fn``'s name)."""
    @functools.wraps(fn)
    def run(module, *args):
        with gathered(module):
            return fn(module, *args)
    return run


@contextlib.contextmanager
def gathered_cache(cache):
    """A layer's cache whose tensors are ``DTensor``s (placed by
    ``cache_specs``) holding, while the context lasts, the rank's rows
    whole in every other dim; on exit each is cut back to the rank's block
    and written into its local tensor, so an update in place is kept. A
    replicated tensor is its local tensor itself. Nothing to do for a
    cache of plain tensors."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.rules import cache_leaves
    swapped = []
    try:
        for _, obj, f in cache_leaves(cache):
            t = getattr(obj, f)
            if not isinstance(t, DTensor):
                continue
            local = t.to_local()
            dims = dtensor_dims(t, skip_dims=(0,))
            full = mesh_mod.gather_dims(local, t.device_mesh, dims)
            setattr(obj, f, full)
            swapped.append((obj, f, t, local, dims, full))
        yield
    finally:
        for obj, f, t, local, dims, full in swapped:
            if full is not local:
                local.copy_(mesh_mod.local_of(full, t.device_mesh, dims))
            setattr(obj, f, t)


def dtensor_dims(t, skip_dims=()) -> dict:
    """``{dim: axes}`` of a ``DTensor``'s placements, the axes of a dim in
    the mesh's order (outermost first); the dims in ``skip_dims`` left
    out."""
    dims = {}
    for axis, place in zip(t.device_mesh.mesh_dim_names, t.placements):
        if place.is_shard():
            if place.dim not in skip_dims:
                dims.setdefault(place.dim, ())
                dims[place.dim] += (axis,)
        elif not place.is_replicate():
            raise ValueError(f"unsupported placement {place}")
    return dims
