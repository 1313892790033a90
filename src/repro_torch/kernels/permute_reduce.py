"""Launch of the batched permuted gather-reduce CUDA kernels
(``csrc/permute_reduce.cu``).

Replaces the Pallas kernel
``repro/kernels/permute_reduce.py::permute_reduce_kernel``. A block owns one
(condensed chunk, permutation) pair, stages that permutation's order row in
shared memory, gathers ``xc`` through L2 by closed-form triangle indexing
and writes one fp64 partial per (chunk, s, b) (``permute_reduce_partials``);
a second kernel sums the partials over the chunks in a fixed order
(``permute_reduce_finish``). No float atomics, so the result is bitwise
reproducible. The ragged last chunk is masked in the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: invariant rows one launch reduces against the same gather (Mantel
#: streams 1, partial Mantel 2).
MAX_ROWS = 2
#: the CUDA grid's limit on blocks (chunks × permutations).
MAX_BLOCKS = 2**31 - 1


def permute_reduce_partials(xc: torch.Tensor, ys: torch.Tensor,
                            ii: torch.Tensor, jj: torch.Tensor,
                            orders: torch.Tensor, *,
                            chunk: int) -> torch.Tensor:
    """(chunks, S, B) fp64 partial sums of the gather-reduce, one per
    condensed chunk of ``chunk`` entries.

    xc: (m,) fp32; ys: (S, m) fp32 with 1 <= S <= MAX_ROWS; ii/jj: (m,)
    int32; orders: (B, n) int32; all contiguous on one CUDA device,
    m = n(n−1)/2 >= 1. Returns without synchronising.
    """
    rows, m = ys.shape
    perms, n = orders.shape
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"one launch takes 1..{MAX_ROWS} rows, got {rows}")
    num_chunks = -(-m // chunk)
    if num_chunks * perms > MAX_BLOCKS:
        raise ValueError(f"{num_chunks} chunks x {perms} permutations exceed "
                         f"the CUDA grid; raise the chunk")
    partials = torch.empty((num_chunks, rows, perms), dtype=torch.float64,
                           device=xc.device)
    err = _build.library().repro_permute_reduce_partials(
        xc.data_ptr(), ys.data_ptr(), ii.data_ptr(), jj.data_ptr(),
        orders.data_ptr(), partials.data_ptr(), n, m, m, rows, perms, chunk,
        num_chunks, _build.stream_handle(xc.device))
    _build.launches["permute_reduce"] += 1
    _build.check(err, "permute_reduce")
    return partials


def permute_reduce_finish(partials: torch.Tensor) -> torch.Tensor:
    """(S, B) fp32 sums over the chunk axis of (chunks, S, B) fp64
    partials, in a fixed order. Returns without synchronising."""
    num_chunks, rows, perms = partials.shape
    out = torch.empty((rows, perms), dtype=torch.float32,
                      device=partials.device)
    err = _build.library().repro_permute_reduce_finish(
        partials.data_ptr(), out.data_ptr(), num_chunks, rows * perms,
        _build.stream_handle(partials.device))
    _build.launches["permute_reduce_finish"] += 1
    _build.check(err, "permute_reduce_finish")
    return out


def permute_reduce_kernel(xc: torch.Tensor, ys: torch.Tensor,
                          ii: torch.Tensor, jj: torch.Tensor,
                          orders: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """out[s, b] = Σ_k ys[s, k]·xc[tri(orders[b, ii[k]], orders[b, jj[k]])]
    on the card, (S, B) fp32; S above ``MAX_ROWS`` runs in slabs of rows,
    each one gather."""
    rows = ys.shape[0]
    return torch.cat([
        permute_reduce_finish(permute_reduce_partials(
            xc, ys[s0:s0 + MAX_ROWS], ii, jj, orders, chunk=chunk))
        for s0 in range(0, rows, MAX_ROWS)])
