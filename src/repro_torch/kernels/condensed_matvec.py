"""Launch of the condensed centred-Gram product (``csrc/condensed_matvec.cu``).

``F @ X`` for the Gower-centred F of the distances a feature-table
production leaves in condensed (scipy ``pdist``) layout, read straight from
the (n(n−1)/2,) vector: one launch a product of up to 128 columns, where the
plain version gathers a (256, n) strip of D at a time with about 22 small
torch ops. No Pallas kernel corresponds: the reference gathers its strips
with jnp ops.

The kernel sweeps each strip of 64 output rows over D's columns with a
thread-block cluster of :func:`sweep_split` blocks, up to 32 columns of X a
block (wider X in ``ceil(k / 32)`` groups of blocks), fp32 FMAs on the CUDA
cores, and sums every output element in an order that depends on (n, k)
alone: two launches give the same bits, and a column's bits do not depend
on the columns beside it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.center_matvec import SM_COUNT
from repro_torch.kernels.dispatch import require, same_device

#: widest X block one launch takes (wider X goes through in slabs)
KMAX = 128
#: output rows of a strip (``kBM`` of ``csrc/condensed_matvec.cu``)
STRIP_ROWS = 64
#: D columns (X rows) of one stage of a strip's sweep (``kBN``)
STAGE_COLS = 32
#: X columns one block takes (``kGroup``); a launch runs ceil(k / 32) groups
GROUP_COLS = 32
#: blocks that may share a strip's sweep (the cluster's sizes)
SWEEP_SPLITS = (1, 2, 4)
#: int32 triangle indexing is exact up to this n (``kMaxN``)
MAX_N = 46340


def width(k: int) -> int:
    """The columns a block computes (the kernel's instantiation): k
    rounded up to 4 up to 32 columns, and 32 above."""
    return min(-(-k // 4) * 4, GROUP_COLS)


def blocks_per_sm(k: int) -> int:
    """Blocks of the kernel an SM holds at once (``min_blocks``): three up
    to 20 columns, two above."""
    return 3 if width(k) <= 20 else 2


def sweep_split(n: int, k: int) -> int:
    """Blocks of the cluster that sweeps one strip, a function of (n, k)
    alone, so the bits never depend on the card: the largest s of
    SWEEP_SPLITS with every block resident at once on an H100
    (strips · groups · s <= SM_COUNT · blocks_per_sm(k)) and s at most the
    ceil(n / STAGE_COLS) stages. 1 where the strips alone fill the card."""
    blocks = -(-n // STRIP_ROWS) * -(-k // GROUP_COLS)
    stages = -(-n // STAGE_COLS)
    return max(s for s in SWEEP_SPLITS
               if s == 1 or (blocks * s <= SM_COUNT * blocks_per_sm(k)
                             and s <= stages))


def geometry(n: int, k: int) -> dict:
    """One launch at (n, k <= KMAX): strips of ``strip_rows`` output rows,
    each swept by a cluster of ``split`` blocks of ``width`` columns."""
    return {"strip_rows": STRIP_ROWS, "width": width(k),
            "split": sweep_split(n, k)}


def condensed_matvec_cost(n: int, k: int) -> tuple[float, float]:
    """(bytes, operations) of one launch: every pair loaded twice, once for
    each of its rows; X loaded once by each of the ceil(n / STRIP_ROWS)
    strips; the row means once and colsum and corr by each strip's
    epilogue; the output stored once. Operations: two an (i, j, c) FMA, and
    the square of each D value once a group of columns."""
    m = n * (n - 1) // 2
    strips = -(-n // STRIP_ROWS)
    groups = -(-k // GROUP_COLS)
    loads = 4.0 * (2 * m + strips * (n * k + 2 * k) + n)
    return loads + 4.0 * n * k, 2.0 * n * n * k + 1.0 * groups * n * n


def condensed_matvec(dc: torch.Tensor, x: torch.Tensor,
                     row_means: torch.Tensor, colsum: torch.Tensor,
                     corr: torch.Tensor, n: int) -> torch.Tensor:
    """(n, k) ``E@X − r·colsumᵀ + corrᵀ`` on the card, ``E = −½ D∘D`` with
    D read from the condensed ``dc``, 2 <= n <= MAX_N, 1 <= k <= KMAX.

    All operands fp32, contiguous, on one CUDA device: dc (n(n−1)/2,), x
    (n, k), row_means (n,), colsum and corr (k,). One launch, each strip
    swept by a cluster of ``sweep_split(n, k)`` blocks. Returns without
    synchronising.
    """
    k = x.shape[-1]
    if not 2 <= n <= MAX_N:
        raise ValueError(f"condensed_matvec takes 2 <= n <= {MAX_N}, "
                         f"got {n}")
    if not 1 <= k <= KMAX:
        raise ValueError(f"condensed_matvec takes 1 <= k <= {KMAX}, got {k}")
    for name, t, shape in (("dc", dc, (n * (n - 1) // 2,)), ("x", x, (n, k)),
                           ("row_means", row_means, (n,)),
                           ("colsum", colsum, (k,)), ("corr", corr, (k,))):
        require(t, name, torch.float32, shape)
    if same_device(dc, x, row_means, colsum, corr).type != "cuda":
        raise ValueError("condensed_matvec runs on a CUDA device")
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    lib = _build.library()
    err = lib.repro_condensed_matvec(dc.data_ptr(), x.data_ptr(),
                                     row_means.data_ptr(), colsum.data_ptr(),
                                     corr.data_ptr(), out.data_ptr(), n, k,
                                     sweep_split(n, k),
                                     _build.stream_handle(x.device))
    _build.launches["condensed_matvec"] += 1
    if _build.recorder is not None:
        _build.recorder("condensed_matvec", *condensed_matvec_cost(n, k))
    _build.check(err, "condensed_matvec")
    return out


def resident_clusters(k: int, split: int) -> int:
    """Clusters of ``split`` blocks of the kernel at k columns that the
    current card holds at once (``cudaOccupancyMaxActiveClusters``)."""
    count = ctypes.c_int(0)
    _build.check(_build.library().repro_condensed_matvec_clusters(
        k, split, ctypes.byref(count)), "condensed_matvec_clusters")
    return count.value
