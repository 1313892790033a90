"""Inverse permutation orders of a tile, on the card
(``csrc/inverse_orders.cu``) or in plain PyTorch.

The row-stationary ``permute_reduce`` and ``mantel_corr`` kernels walk the
pairs of each permutation from the side of the permuted operand, so they
need ``inv[b, orders[b, i]] = i``, and read the orders themselves as a
16-bit copy. On an order row that is not a permutation of 0..n−1 they
would read out of range or return a silently wrong sum, so
:func:`inverse_orders` refuses any such tile. No Pallas kernel of the
reference is replaced: the TPU kernels gathered from the other side and
never formed the inverse.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: widest order a 16-bit copy holds: the one place the limit is set (the
#: kernel writes values 0..n-1 to 16 bits).
MAX_N = 2**16
#: blocks of a row's thread-block cluster: the portable sizes.
CLUSTER_SIZES = (1, 2, 4, 8)
#: shared memory a block's slice of a row's inverse may take: what a block
#: gets without opting in.
SLICE_BYTES = 48 * 1024
#: blocks a tile should light, about the card's 132 SMs.
FILL_BLOCKS = 128


def cluster_size(perms: int, n: int) -> int:
    """Blocks of the cluster that inverts one order row, a function of
    (perms, n) alone: the smallest C of CLUSTER_SIZES, C <= n, with
    perms·C >= FILL_BLOCKS and a slice of ceil(n / C) int32 slots within
    SLICE_BYTES; where none reaches FILL_BLOCKS, the largest such C."""
    fits = [c for c in CLUSTER_SIZES
            if c <= n and 4 * -(-n // c) <= SLICE_BYTES]
    if not fits:
        raise ValueError(f"no cluster of {CLUSTER_SIZES} holds a row of "
                         f"n={n} in {SLICE_BYTES} bytes a block")
    return next((c for c in fits if perms * c >= FILL_BLOCKS), fits[-1])


def inverse_orders_cost(perms: int, n: int, cluster: int
                        ) -> tuple[float, float]:
    """(bytes, operations) of one ``inverse_orders`` launch: each of a
    row's ``cluster`` blocks reads the whole int32 order row (from device
    memory once, from L2 for the others); inv (int32), the 16-bit copy
    and the flags are stored once. No arithmetic."""
    return perms * (4.0 * n * cluster + 6.0 * n + 4.0), 0.0


def inverse_orders_kernel(orders: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(inv, orders16, is_perm)`` on the card: (B, n) int32, (B, n) int16
    holding the orders' 16 low bits, (B,) int32 flags. orders: (B, n) int32,
    contiguous, 1 <= n <= MAX_N. One launch: a cluster of
    :func:`cluster_size` blocks a row. Returns without synchronising."""
    perms, n = orders.shape
    inv = torch.empty((perms, n), dtype=torch.int32, device=orders.device)
    orders16 = torch.empty((perms, n), dtype=torch.int16,
                           device=orders.device)
    is_perm = torch.empty((perms,), dtype=torch.int32, device=orders.device)
    cluster = cluster_size(perms, n)
    err = _build.library().repro_inverse_orders(
        orders.data_ptr(), inv.data_ptr(), orders16.data_ptr(),
        is_perm.data_ptr(), n, perms, cluster,
        _build.stream_handle(orders.device))
    _build.launches["inverse_orders"] += 1
    if _build.recorder is not None:
        _build.recorder("inverse_orders",
                        *inverse_orders_cost(perms, n, cluster))
    _build.check(err, "inverse_orders")
    return inv, orders16, is_perm


def inverse_orders_plain(orders: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: one scatter a tile. Where a
    row is not a permutation, its ``inv`` holds -1 in the slots no entry
    reached and an arbitrary one of the entries that collide."""
    perms, n = orders.shape
    o = orders.long()
    valid = (o >= 0) & (o < n)
    inv = torch.full((perms, n + 1), -1, dtype=torch.int32,
                     device=orders.device)
    positions = torch.arange(n, dtype=torch.int32, device=orders.device)
    inv.scatter_(1, torch.where(valid, o, n), positions.expand(perms, n))
    inv = inv[:, :n].contiguous()
    is_perm = valid.all(dim=1) & (inv >= 0).all(dim=1)
    return inv, (orders & 0xFFFF).to(torch.int16), is_perm.to(torch.int32)


def inverse_orders(orders: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(inv, orders16)`` of a (B, n) tile of integer orders: the kernel on
    a CUDA tensor, the plain version on a CPU tensor. Raises ValueError
    unless every row is a permutation of 0..n−1; that check synchronises
    with the card once a call."""
    if orders.ndim != 2:
        raise ValueError(f"orders must be (B, n), got {tuple(orders.shape)}")
    perms, n = orders.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"orders take 1 <= n <= {MAX_N} (a 16-bit copy "
                         f"is kept), got n={n}")
    orders = orders.to(torch.int32).contiguous()
    if orders.device.type == "cuda":
        inv, orders16, is_perm = inverse_orders_kernel(orders)
    elif orders.device.type == "cpu":
        inv, orders16, is_perm = inverse_orders_plain(orders)
    else:
        raise ValueError(f"unsupported device {orders.device}")
    require_permutations(is_perm, n)
    return inv, orders16


def require_permutations(is_perm: torch.Tensor, n: int) -> None:
    """Raise ValueError unless every flag of ``is_perm`` is set."""
    if is_perm.numel() and not bool(is_perm.all()):
        bad = int(torch.nonzero(is_perm == 0)[0, 0])
        raise ValueError(f"order row {bad} is not a permutation of 0..{n - 1}")
