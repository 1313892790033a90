"""Public wrapper for the batched Mantel-correlation kernel.

The counterpart of ``repro/kernels/mantel_corr_ops.py::mantel_corr_pallas``,
paper Algorithm 5 over square operands: hoist (x̄, ‖x−x̄‖, ŷ), build the
full symmetric ŷ with a zero diagonal (so the square sum is twice the
condensed one), reduce ``perm_batch`` permutations at a time, and scale by
1/(2‖x−x̄‖). On a CUDA tensor each batch is one launch of the
``inverse_orders`` kernel and one of the ``mantel_corr`` kernel, which
gathers the permuted rows itself and masks a ragged n; on a CPU tensor the
plain version runs. Either way an order that is not a permutation is
refused. Nothing is padded (the reference pads n to 128-lane blocks for the
TPU).

``mantel_corr_sums_op`` is the raw reduction over a column range of ŷ
(the kernel's column-range mode), for the distributed Mantel test.
"""

from __future__ import annotations

import torch

from repro_torch.core.distance_matrix import condensed_form, condensed_to_square
from repro_torch.kernels.dispatch import require, same_device
from repro_torch.kernels.inverse_orders import inverse_orders
from repro_torch.kernels.mantel_corr import mantel_corr
from repro_torch.kernels.mantel_corr_ref import mantel_corr_plain
from repro_torch.obs.compile import note_trace


def _require_orders(orders: torch.Tensor, n: int) -> None:
    """Refuse orders that are not (K, n), or whose indices leave [0, n):
    the kernel reads x at them."""
    if orders.ndim != 2 or orders.shape[1] != n:
        raise ValueError(f"orders must be (K, {n}), got {tuple(orders.shape)}")
    if orders.shape[0] and (int(orders.min()) < 0 or int(orders.max()) >= n):
        raise ValueError(f"orders must hold indices in [0, {n})")


def mantel_corr_hoist(x: torch.Tensor, y: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The permutation-invariant statistics (the paper's tricks): ‖x−x̄‖
    over the condensed x, and the full symmetric ŷ with a zero diagonal."""
    x_flat = condensed_form(x)
    normxm = torch.linalg.vector_norm(x_flat - x_flat.mean())
    y_flat = condensed_form(y)
    ym = y_flat - y_flat.mean()
    return normxm, condensed_to_square(ym / torch.linalg.vector_norm(ym),
                                       x.shape[0])


def mantel_corr_op(x: torch.Tensor, y: torch.Tensor, orders: torch.Tensor,
                   *, perm_batch: int = 8) -> torch.Tensor:
    """Pearson r for every permutation in ``orders`` ((K, n) integers).

    x, y: full symmetric hollow (n, n) fp32 distance matrices on one
    device. K must be a multiple of ``perm_batch``. Returns (K,) fp32.
    """
    n = x.shape[0]
    require(x, "x", torch.float32, (n, n))
    require(y, "y", torch.float32, (n, n))
    device = same_device(x, y, orders)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    note_trace("kernels.mantel_corr", (n, perm_batch, x.dtype, device.type))
    k_perms = orders.shape[0]
    _require_orders(orders, n)
    normxm, yhat = mantel_corr_hoist(x, y)
    if perm_batch < 1 or k_perms % perm_batch:
        raise ValueError(f"permutations ({k_perms}) must be divisible by "
                         f"perm_batch ({perm_batch})")
    orders = orders.to(torch.int32).contiguous()
    if device.type == "cuda":
        reduce = mantel_corr                       # refuses each batch itself
    else:
        if k_perms:
            inverse_orders(orders)                 # refuse non-permutations
        reduce = mantel_corr_plain
    stats = [reduce(x, yhat, orders[b0:b0 + perm_batch])
             for b0 in range(0, k_perms, perm_batch)]
    stats = torch.cat(stats) if stats else \
        torch.zeros((0,), dtype=torch.float32, device=device)
    return stats / (2.0 * normxm)


def mantel_corr_sums_op(x: torch.Tensor, yhat: torch.Tensor,
                        orders: torch.Tensor, c0: int = 0) -> torch.Tensor:
    """(B,) fp32 ``Σ_i Σ_{j∈[c0, c0+c)} x[o_b[i], o_b[j]]·ŷ[i, j − c0]`` for
    an (n, n) x and ŷ the square's (n, c) columns from ``c0``: on the card
    the ``mantel_corr`` kernel (slabs of 128 orders, each a launch pair),
    on the CPU its plain version. Orders that are not permutations are
    refused either way."""
    n, cols = yhat.shape
    require(x, "x", torch.float32, (n, n))
    require(yhat, "yhat", torch.float32, (n, cols))
    device = same_device(x, yhat, orders)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    _require_orders(orders, n)
    orders = orders.to(torch.int32).contiguous()
    if not orders.shape[0]:
        return torch.zeros((0,), dtype=torch.float32, device=device)
    if device.type == "cuda":
        return mantel_corr(x, yhat, orders, c0)
    inverse_orders(orders)                      # refuse non-permutations
    return mantel_corr_plain(x, yhat, orders, c0)
