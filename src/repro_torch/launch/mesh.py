"""Device meshes over ``torch.distributed``, and the collectives of the
distributed analysis paths.

The counterpart of ``repro/launch/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names (``"data"``, ``"model"``, optionally ``"pod"``) over the process
group that exists; every rank of the group runs the same code (SPMD), as
``shard_map`` runs one program per device. ``jax.lax.axis_index`` is the
rank's coordinate on an axis (``axis_index``), and ``psum`` and
``all_gather(tiled=True)`` are an ``all_gather`` over the axis's sub-group
followed, for ``psum``, by a sum in rank order. So every rank holds the
same bits, and no result depends on the backend's reduction algorithm;
the payloads of the analysis paths are O(n) or O(n·k).

A block-sharded global array is a ``DTensor`` built with
``DTensor.from_local`` from the rank's own block (no scatter from a root:
gloo may refuse one on CUDA tensors). ``full_tensor`` assembles the global
array with the same gathers.

The reference's v5e constants (peak FLOP/s, HBM and ICI rates) are a
TPU's numbers and are not carried over; ``repro_torch.tune.budget`` reads
the card.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

Axes = Union[str, Sequence[str]]

#: the reference's production meshes: (shape, axis names)
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}

#: what this process's gathers received from its peers, the bytes that
#: crossed the interconnect (set to 0 with ``reset_gathered``)
gathered = {"calls": 0, "bytes": 0}


def reset_gathered() -> None:
    for name in gathered:
        gathered[name] = 0


def make_host_mesh(shape: Sequence[int] = (1, 1),
                   axes: Sequence[str] = ("data", "model"),
                   device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` over the process group that exists, its ranks
    laid out row-major. With no group and a one-rank shape it creates a
    one-rank group in this process: NCCL for ``device_type="cuda"``, gloo
    for ``"cpu"``. Any other size must match the group's world size."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a CUDA card; pass "
                           "device_type='cpu' for the CPU")
    size = math.prod(shape)
    if not dist.is_initialized():
        if size != 1:
            raise ValueError(f"a {shape} mesh needs {size} ranks, but no "
                             f"process group exists (a world of 1): start "
                             f"{size} processes and init_process_group")
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if world != size:
        raise ValueError(f"a {shape} mesh needs {size} ranks, the process "
                         f"group has {world}")
    return DeviceMesh(device_type, torch.arange(size).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The reference's (16, 16) ``("data", "model")`` mesh, or (2, 16, 16)
    with ``"pod"``; refused unless the world has that many ranks."""
    shape, axes = PRODUCTION[bool(multi_pod)]
    return make_host_mesh(shape, axes, device_type)


def mesh_chips(mesh: DeviceMesh) -> int:
    return mesh.size()


def _as_axes(axes: Axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh: DeviceMesh, axes: Axes) -> int:
    """Ranks along ``axes`` (their product for several)."""
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for a in _as_axes(axes))


def axis_index(mesh: DeviceMesh, axes: Axes) -> int:
    """This rank's coordinate on ``axes``, row-major over several."""
    index = 0
    for a in _as_axes(axes):
        index = index * axis_size(mesh, a) + mesh.get_local_rank(a)
    return index


def check_device(mesh: DeviceMesh, *tensors: torch.Tensor) -> None:
    """Refuse a tensor that does not lie on the mesh's device type."""
    for t in tensors:
        if t.device.type != mesh.device_type:
            raise ValueError(f"a {t.device.type} tensor on a "
                             f"{mesh.device_type} mesh")


def _gather(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """(P, *t.shape): ``t`` of every rank along ``axis``, in the order of
    their coordinates on it."""
    group = mesh.get_group(axis)
    dim = mesh.mesh_dim_names.index(axis)
    coord = list(mesh.get_coordinate())
    peers = []
    for i in range(mesh.size(dim)):
        coord[dim] = i
        peers.append(int(mesh.mesh[tuple(coord)]))
    parts = [torch.empty_like(t) for _ in peers]
    dist.all_gather(parts, t.contiguous(), group=group)
    gathered["calls"] += 1
    gathered["bytes"] += t.numel() * t.element_size() * (len(peers) - 1)
    return torch.stack([parts[dist.get_group_rank(group, r)] for r in peers])


def gather_stack(t: torch.Tensor, mesh: DeviceMesh, axes: Axes
                 ) -> torch.Tensor:
    """(P, *t.shape): ``t`` of every rank along ``axes``, row-major in
    their coordinates (the first axis outermost)."""
    stack = t[None]
    for a in reversed(_as_axes(axes)):
        stack = _gather(stack, mesh, a).flatten(0, 1)
    return stack


def psum(t: torch.Tensor, mesh: DeviceMesh, axes: Axes,
         dtype: Union[torch.dtype, None] = None) -> torch.Tensor:
    """The sum of ``t`` over the ranks along ``axes``: gathered, then
    summed in rank order (in ``dtype``, default ``t``'s), so every rank
    holds the same bits whatever the backend."""
    stack = gather_stack(t, mesh, axes)
    if dtype is not None:
        stack = stack.to(dtype)
    total = stack[0].clone()
    for part in stack[1:]:
        total += part
    return total


def all_gather_tiled(t: torch.Tensor, mesh: DeviceMesh, axes: Axes,
                     dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` along ``axes`` concatenated on ``dim`` in rank
    order (``jax.lax.all_gather(tiled=True)``)."""
    return torch.cat(list(gather_stack(t, mesh, axes)), dim=dim)


def placements(mesh: DeviceMesh, shards: dict) -> list:
    """A DTensor's placements: ``Shard(shards[axis])`` on the named axes,
    ``Replicate()`` on the others."""
    return [Shard(shards[a]) if a in shards else Replicate()
            for a in mesh.mesh_dim_names]


def full_tensor(t) -> torch.Tensor:
    """The global array of a DTensor, by this module's gathers (a plain
    tensor passes through)."""
    if not isinstance(t, DTensor):
        return t
    local = t.to_local()
    mesh = t.device_mesh
    # the rightmost mesh axis sharding a tensor dim is its innermost split
    for axis, place in reversed(list(zip(mesh.mesh_dim_names,
                                         t.placements))):
        if place.is_shard():
            local = all_gather_tiled(local, mesh, axis, dim=place.dim)
        elif not place.is_replicate():
            raise ValueError(f"unsupported placement {place}")
    return local


def local_block(d, mesh: DeviceMesh, row_axis: str, col_axis: str):
    """This rank's contiguous (r, c) block of an (n, n) matrix block-sharded
    rows over ``row_axis`` and columns over ``col_axis``, with its row and
    column offsets and n: ``(block, i0, j0, n)``. ``d`` is a plain tensor
    every rank holds, or a DTensor placed ``Shard(0)`` on ``row_axis``,
    ``Shard(1)`` on ``col_axis`` and replicated on the other axes. n must
    divide over both axes."""
    n = d.shape[0]
    if len(d.shape) != 2 or d.shape[1] != n:
        raise ValueError(f"expected a square matrix, got {tuple(d.shape)}")
    pr, pc = axis_size(mesh, row_axis), axis_size(mesh, col_axis)
    if n % pr or n % pc:
        raise ValueError(f"n = {n} must divide over the {pr} ranks of "
                         f"{row_axis!r} and the {pc} of {col_axis!r}")
    r, c = n // pr, n // pc
    i0, j0 = axis_index(mesh, row_axis) * r, axis_index(mesh, col_axis) * c
    if isinstance(d, DTensor):
        want = placements(mesh, {row_axis: 0, col_axis: 1})
        if d.device_mesh != mesh or list(d.placements) != want:
            raise ValueError(f"d must be placed {want} on this mesh, got "
                             f"{list(d.placements)}")
        block = d.to_local().contiguous()
    else:
        block = d[i0:i0 + r, j0:j0 + c].contiguous()
    check_device(mesh, block)
    return block, i0, j0, n
