"""Launch of the fused center-matvec CUDA kernel (``csrc/center_matvec.cu``).

Replaces the Pallas kernel ``repro/kernels/center_matvec.py::center_matvec``:
``F @ X`` for the Gower-centred F with ``E = −½D∘D`` formed in registers
from each D tile as it leaves shared memory, products on the tensor cores in
3xTF32 (each operand split into tf32 hi and lo parts; about fp32's
accuracy), and the rank-1 corrections ``−r_i·colsumᵀ + corrᵀ`` in the
epilogue. A producer warp keeps a ring of D and X tiles in flight. Each
strip of 128 output rows is swept by a thread-block cluster of
:func:`sweep_split` blocks, each over its own share of the columns, their
sums added in rank order through distributed shared memory in the same
launch; the split is a function of the shape alone, so two launches give
the same bits on any card. D may also be an (r, c) block with X of (c, k)
(block mode, for the distributed matvec): an (8192, 8192) block's 64
strips take clusters of 2, where the square's 128 strips at n = 16384
take one block each.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: widest X block one launch takes: the square-operator PERMANOVA's tile
#: of 32 permutations x 4 groups.
KMAX = 128
#: output rows of a strip (``kBM`` of ``csrc/center_matvec.cu``): a launch
#: runs ceil(rows / STRIP_ROWS) strips, each swept by a cluster of
#: :func:`sweep_split` blocks.
STRIP_ROWS = 128
#: D columns (X rows) of one stage of a strip's sweep (``kBN``).
STAGE_COLS = 32
#: blocks that may share a strip's sweep: the portable cluster sizes.
SWEEP_SPLITS = (1, 2, 4, 8)
#: the H100's SMs; a block takes a whole SM (134–214 KB of shared memory).
SM_COUNT = 132
#: clusters of each size that an H100 holds at once, by
#: ``cudaOccupancyMaxActiveClusters`` (:func:`resident_clusters`, the same
#: at every k) on an H100 80GB HBM3. A cluster lies within one group of
#: SMs (a GPC), whose SM counts are not all multiples of 4, so clusters of
#: 4 and 8 use only 120 of the 132 SMs. More strips than this at one size
#: would run a second wave.
RESIDENT_CLUSTERS = {1: SM_COUNT, 2: 66, 4: 30, 8: 15}
#: widths the kernel is instantiated at (8-column n-tiles, ``by_width``).
_TILES = (1, 2, 3, 4, 6, 8, 12, 16)


def _padded_width(k: int) -> int:
    """The columns k is padded to in shared memory and registers."""
    return 8 * next(t for t in _TILES if 8 * t >= k)


def ring_stages(k: int) -> int:
    """Stages of the producer's ring at k columns (``ring_stages`` of
    ``csrc/center_matvec.cu``): 6 up to 64 padded columns, 4 above."""
    return 4 if _padded_width(k) > 64 else 6


def _room_after_sweep(k: int) -> int:
    """Bytes of shared memory past the mbarriers at k columns, which a
    cluster's sum may reuse once the sweep is over (``Layout`` of
    ``csrc/center_matvec.cu``: the D and X rings, two split X tiles)."""
    kp = _padded_width(k)
    stages = ring_stages(k)
    return (stages * STRIP_ROWS * (STAGE_COLS + 8) * 4
            + stages * STAGE_COLS * k * 4 + 2 * (STAGE_COLS // 2) * (kp + 2)
            * 16)


def sweep_split(rows: int, cols: int, k: int) -> int:
    """Blocks of the cluster that sweeps one strip, a function of (rows,
    cols, k) alone, so the bits never depend on the card: the largest s of
    SWEEP_SPLITS with the strips' clusters resident at once (strips <=
    RESIDENT_CLUSTERS[s], one wave), s <= the ceil(cols / STAGE_COLS)
    stages (each rank has one) and the slots of ranks 1..s−1,
    (s−1)·STRIP_ROWS·_padded_width(k) fp32, within the shared memory the
    sweep leaves idle. 1 where the strips alone fill the card."""
    strips = -(-rows // STRIP_ROWS)
    stages = -(-cols // STAGE_COLS)
    room = _room_after_sweep(k)
    return max(s for s in SWEEP_SPLITS
               if s == 1 or (strips <= RESIDENT_CLUSTERS[s] and s <= stages
                             and (s - 1) * STRIP_ROWS * _padded_width(k) * 4
                             <= room))


def geometry(rows: int, cols: int, k: int) -> dict:
    """(rows, cols) D against (cols, k) X: ``launches`` of ``width`` columns,
    each strip of ``strip_rows`` output rows swept by a cluster of ``split``
    blocks, a ring of ``stages`` stages of ``stage_cols`` D columns."""
    width = min(max(k, 1), KMAX)
    return {"strip_rows": STRIP_ROWS, "max_columns": KMAX, "width": width,
            "launches": -(-max(k, 1) // KMAX), "stage_cols": STAGE_COLS,
            "stages": ring_stages(width),
            "split": sweep_split(rows, cols, width)}


def center_matvec_cost(rows: int, cols: int, k: int) -> tuple[float, float]:
    """(bytes, operations) of one ``center_matvec`` launch: D read once;
    each of the ceil(rows / STRIP_ROWS) strips reads every row of X once
    between its cluster's ranks (each rank its own stages; the sum
    across ranks goes through distributed shared memory, not device
    memory) and the k column sums and corrections; the row means read and
    the output stored once. Operations: E = −½d∘d, two a D element, and
    three tf32 products (3xTF32), 2·rows·cols·k each."""
    strips = -(-rows // STRIP_ROWS)
    loads = 4.0 * (rows * cols + strips * (cols * k + 2 * k) + rows)
    return loads + 4.0 * rows * k, 6.0 * rows * cols * k + 2.0 * rows * cols


def center_matvec(d: torch.Tensor, x: torch.Tensor, row_means: torch.Tensor,
                  colsum: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """(r, k) ``E@X − r·colsumᵀ + corrᵀ`` on the card, 1 <= k <= KMAX.

    All operands fp32, contiguous, on one CUDA device: d (r, c), the
    square matrix or a block of it, x (c, k), row_means (r,), colsum and
    corr (k,). One launch, each strip swept by a cluster of
    ``sweep_split(r, c, k)`` blocks. Returns without synchronising.
    """
    rows, cols = d.shape
    k = x.shape[1]
    if x.shape[0] != cols:
        raise ValueError(f"x must have {cols} rows, got {tuple(x.shape)}")
    if not 1 <= k <= KMAX:
        raise ValueError(f"center_matvec takes 1 <= k <= {KMAX}, got {k}")
    out = torch.empty((rows, k), dtype=torch.float32, device=d.device)
    if rows == 0:
        return out
    lib = _build.library()
    err = lib.repro_center_matvec(d.data_ptr(), x.data_ptr(),
                                  row_means.data_ptr(), colsum.data_ptr(),
                                  corr.data_ptr(), out.data_ptr(), rows,
                                  cols, k, sweep_split(rows, cols, k),
                                  _build.stream_handle(d.device))
    _build.launches["center_matvec"] += 1
    if _build.recorder is not None:
        _build.recorder("center_matvec", *center_matvec_cost(rows, cols, k))
    _build.check(err, "center_matvec")
    return out


def resident_clusters(k: int, split: int) -> int:
    """Clusters of ``split`` blocks of the kernel at k columns that the
    current card holds at once (``cudaOccupancyMaxActiveClusters``): below
    SM_COUNT / split where the card's SM groups leave SMs that no whole
    cluster fits. ``RESIDENT_CLUSTERS`` holds an H100's."""
    count = ctypes.c_int(0)
    _build.check(_build.library().repro_center_matvec_clusters(
        k, split, ctypes.byref(count)), "center_matvec_clusters")
    return count.value
