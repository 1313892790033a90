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
array with the same gathers (none over an axis of one rank).

The LM on a mesh adds the collectives a sharded step differentiates
through, each over the axes of size above 1 only (an axis of size 1 issues
none, and its function is the identity): ``gather_leaf`` assembles a
weight from the rank's block at use, and its backward sums the gradient
over the batch axes in rank order (a reduce-scatter, ``reduce_scatter``,
where the axis splits one of the leaf's dims; a gather and a rank-order
sum where it does not) and keeps the rank's block; ``copy_to``
(identity, its backward a ``psum``), ``reduce_from`` (a ``psum``, its
backward the identity) and ``all_reduce`` (a ``psum`` both ways) carry the
vocab-sharded loss and the batch statistics; ``pmax`` takes no gradient.
A leaf's sharded dims are ``{dim: axes}``, the axes outermost first.

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


def _peers(mesh: DeviceMesh, axis: str) -> tuple:
    """``(group, [group rank of coordinate i on axis])``."""
    group = mesh.get_group(axis)
    dim = mesh.mesh_dim_names.index(axis)
    coord = list(mesh.get_coordinate())
    ranks = []
    for i in range(mesh.size(dim)):
        coord[dim] = i
        ranks.append(dist.get_group_rank(group, int(mesh.mesh[tuple(coord)])))
    return group, ranks


def _gather(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """(P, *t.shape): ``t`` of every rank along ``axis``, in the order of
    their coordinates on it."""
    group, ranks = _peers(mesh, axis)
    parts = [torch.empty_like(t) for _ in ranks]
    dist.all_gather(parts, t.contiguous(), group=group)
    gathered["calls"] += 1
    gathered["bytes"] += t.numel() * t.element_size() * (len(ranks) - 1)
    return torch.stack([parts[r] for r in ranks])


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
    tensor passes through). A dim split over axes of one rank only is
    copied, not gathered."""
    if not isinstance(t, DTensor):
        return t
    local = out = t.to_local()
    mesh = t.device_mesh
    # the rightmost mesh axis sharding a tensor dim is its innermost split
    for axis, place in reversed(list(zip(mesh.mesh_dim_names,
                                         t.placements))):
        if place.is_shard():
            if axis_size(mesh, axis) > 1:
                out = all_gather_tiled(out, mesh, axis, dim=place.dim)
        elif not place.is_replicate():
            raise ValueError(f"unsupported placement {place}")
    sharded = any(place.is_shard() for place in t.placements)
    return local.clone() if sharded and out is local else out


# --------------------------------------------------------------------------
# the collectives of a sharded step, and their gradients
# --------------------------------------------------------------------------
Dims = dict   # {tensor dim: (mesh axis, ...)}, the axes outermost first


def active_axes(mesh: DeviceMesh, axes: Axes) -> tuple[str, ...]:
    """The axes of ``axes`` with more than one rank."""
    return tuple(a for a in _as_axes(axes) if axis_size(mesh, a) > 1)


def block_slices(shape, mesh: DeviceMesh, dims: Dims) -> tuple:
    """This rank's block of a global ``shape`` split as ``dims`` says: one
    slice a dim, contiguous, the axes of a dim row-major."""
    out = []
    for d, n in enumerate(shape):
        axes = dims.get(d, ())
        parts = axis_size(mesh, axes) if axes else 1
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {axes} ({parts} ranks)")
        i = axis_index(mesh, axes) if axes else 0
        out.append(slice(i * (n // parts), (i + 1) * (n // parts)))
    return tuple(out)


def local_of(full: torch.Tensor, mesh: DeviceMesh, dims: Dims
             ) -> torch.Tensor:
    """This rank's block of a global tensor every rank holds."""
    return full[block_slices(full.shape, mesh, dims)]


def gather_dims(local: torch.Tensor, mesh: DeviceMesh, dims: Dims
                ) -> torch.Tensor:
    """The global tensor of the ranks' blocks: each dim's axes gathered
    innermost first (``full_tensor``'s order)."""
    for d, axes in dims.items():
        for a in reversed(active_axes(mesh, axes)):
            local = all_gather_tiled(local, mesh, a, dim=d)
    return local


def reduce_scatter(t: torch.Tensor, mesh: DeviceMesh, axis: str,
                   dim: int) -> torch.Tensor:
    """This rank's chunk (by its coordinate on ``axis``) along ``dim`` of
    the sum of ``t`` over the ranks of ``axis``, summed in rank order:
    each rank sends each peer only that peer's chunk (an ``all_to_all``)."""
    group, ranks = _peers(mesh, axis)
    p = len(ranks)
    chunks = list(torch.chunk(t, p, dim=dim))
    by_group = [None] * p
    for coord, gr in enumerate(ranks):
        by_group[gr] = chunks[coord].contiguous().reshape(-1)
    send = torch.cat(by_group)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    gathered["calls"] += 1
    gathered["bytes"] += recv.numel() * recv.element_size() * (p - 1) // p
    parts = recv.reshape(p, *chunks[0].shape)
    total = parts[ranks[0]].clone()
    for coord in range(1, p):
        total += parts[ranks[coord]]
    return total


def _reduce_to_block(grad: torch.Tensor, mesh: DeviceMesh, dims: Dims,
                     reduce_axes: tuple) -> torch.Tensor:
    """``grad`` summed over ``reduce_axes`` in rank order and cut to this
    rank's block of ``dims``: an axis that splits no dim is a gather and a
    sum; along a dim, each axis outermost first is a reduce-scatter when it
    is summed over and a cut to the rank's chunk when it is not."""
    reduce_axes = active_axes(mesh, reduce_axes)
    splits = {a for ax in dims.values() for a in ax}
    for a in reduce_axes:
        if a not in splits:
            grad = psum(grad, mesh, a)
    # the dims only cut come first: each reduce-scatter then moves less
    order = sorted(dims.items(), key=lambda kv: any(
        a in reduce_axes for a in active_axes(mesh, kv[1])))
    for d, axes in order:
        for a in active_axes(mesh, axes):
            if a in reduce_axes:
                grad = reduce_scatter(grad, mesh, a, d)
            else:
                grad = torch.chunk(grad, axis_size(mesh, a),
                                   dim=d)[axis_index(mesh, a)]
    return grad.contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, mesh, dims, reduce_axes):
        ctx.mesh, ctx.dims, ctx.reduce_axes = mesh, dims, reduce_axes
        return gather_dims(local, mesh, dims)

    @staticmethod
    def backward(ctx, grad):
        return (_reduce_to_block(grad, ctx.mesh, ctx.dims, ctx.reduce_axes),
                None, None, None)


def gather_leaf(local: torch.Tensor, mesh: DeviceMesh, dims: Dims,
                reduce_axes: Axes = ()) -> torch.Tensor:
    """The global weight from this rank's block, differentiable: the
    backward sums the gradient over ``reduce_axes`` (the axes the batch is
    split over) in rank order and returns this rank's block of it. With
    no axis of size above 1 among ``dims`` and ``reduce_axes`` it is
    ``local`` itself."""
    live = {d: ax for d, ax in dims.items() if active_axes(mesh, ax)}
    if not live and not active_axes(mesh, reduce_axes):
        return local
    return _Gather.apply(local, mesh, live, tuple(reduce_axes))


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return psum(grad.contiguous(), ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return psum(t, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return psum(t, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return psum(grad.contiguous(), ctx.mesh, ctx.axes), None, None


def copy_to(t: torch.Tensor, mesh: DeviceMesh, axes: Axes) -> torch.Tensor:
    """``t`` as it is; its gradient summed over ``axes`` (a value every
    rank of ``axes`` holds, used by each on its own slice of the work)."""
    axes = active_axes(mesh, axes)
    return _CopyTo.apply(t, mesh, axes) if axes else t


def reduce_from(t: torch.Tensor, mesh: DeviceMesh, axes: Axes
                ) -> torch.Tensor:
    """The rank-order sum over ``axes``; the gradient passes as it is (every
    rank of ``axes`` goes on with the same sum)."""
    axes = active_axes(mesh, axes)
    return _ReduceFrom.apply(t, mesh, axes) if axes else t


def all_reduce(t: torch.Tensor, mesh: DeviceMesh, axes: Axes
               ) -> torch.Tensor:
    """The rank-order sum over ``axes``, its gradient summed the same way
    (each rank's loss takes its share of the sum)."""
    axes = active_axes(mesh, axes)
    return _AllReduce.apply(t, mesh, axes) if axes else t


def pmax(t: torch.Tensor, mesh: DeviceMesh, axes: Axes) -> torch.Tensor:
    """The elementwise max over ``axes`` (no gradient)."""
    axes = active_axes(mesh, axes)
    if not axes:
        return t
    return gather_stack(t.detach(), mesh, axes).amax(dim=0)


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
