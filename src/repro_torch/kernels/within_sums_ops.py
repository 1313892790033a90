"""Public wrapper for the within-group rank sums of permuted groupings.

ANOSIM's per-tile reduction. The contract: the ``n <= MAX_TRIANGLE_N``
guard, the shape checks on ``ranks`` and ``codes``, and the empty (B,)
result for n < 2. Every order row must be a permutation of 0..n−1
(``inverse_orders`` refuses the tile otherwise, on either device). The
ranks are read as round(2·rank) / 2: ANOSIM's average ranks are
half-integers, for which that is exact. On a CPU tensor the plain
version runs chunk by chunk over the condensed stream; on a CUDA tensor
the kernel runs.
"""

from __future__ import annotations

import torch

from repro_torch.core.distance_matrix import MAX_TRIANGLE_N
from repro_torch.kernels.dispatch import require, same_device
from repro_torch.kernels.inverse_orders import inverse_orders
from repro_torch.kernels.within_sums import within_sums_kernel
from repro_torch.kernels.within_sums_ref import within_sums_ref
from repro_torch.obs.compile import note_trace

#: condensed pairs per chunk of the plain version: a few (B, chunk) tiles
#: on the CPU.
DEFAULT_CHUNK = 65536


def within_sums(ranks: torch.Tensor, codes: torch.Tensor,
                orders: torch.Tensor) -> torch.Tensor:
    """All B within-group rank sums of one tile of permuted groupings.

    out[b] = Σ_{i<j} ranks[tri(i, j)]·[codes[orders[b, i]] ==
    codes[orders[b, j]]]

    ranks: (m,) fp32 condensed ranks, m = n(n−1)/2; codes: (n,) integer
    group codes; orders: (B, n) integer permutations. Returns (B,) fp32.
    """
    perms, n = orders.shape
    if n > MAX_TRIANGLE_N:
        raise ValueError(
            f"within_sums supports n <= {MAX_TRIANGLE_N} (2·rank below 2^31, "
            f"16-bit orders); got n={n}")
    m = n * (n - 1) // 2
    if tuple(ranks.shape) != (m,):
        raise ValueError(f"ranks must be condensed length m={m} for n={n}, "
                         f"got {tuple(ranks.shape)}")
    if tuple(codes.shape) != (n,) or codes.is_floating_point() \
            or codes.is_complex():
        raise ValueError(f"codes must be ({n},) integers, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    require(ranks, "ranks", torch.float32)
    device = same_device(ranks, codes, orders)
    # one call of ANOSIM's padded per_batch entry: one signature per (n, B)
    # whatever K the engine runs
    note_trace("kernels.within_sums", (n, perms, ranks.dtype, device.type))
    if m == 0:                                     # n < 2: no pair
        return torch.zeros((perms,), dtype=torch.float32, device=device)
    if device.type == "cuda":
        return within_sums_kernel(ranks, codes.to(torch.int32).contiguous(),
                                  orders)
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    inverse_orders(orders)                         # refuse non-permutations
    return within_sums_ref(ranks, codes, orders, DEFAULT_CHUNK)
