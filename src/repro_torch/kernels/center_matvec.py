"""Launch of the fused center-matvec CUDA kernel (``csrc/center_matvec.cu``).

Replaces the Pallas kernel ``repro/kernels/center_matvec.py::center_matvec``:
``F @ X`` for the Gower-centred F with ``E = −½D∘D`` formed in registers
from each D tile as it leaves shared memory, products on the tensor cores in
3xTF32 (each operand split into tf32 hi and lo parts; about fp32's
accuracy), and the rank-1 corrections ``−r_i·colsumᵀ + corrᵀ`` in the
epilogue. A producer warp keeps a ring of D and X tiles in flight; one block
owns 128 output rows and sweeps all columns, so no sum crosses blocks and
two launches give the same bits. D may also be an (r, c) block with X of
(c, k) (block mode, for the distributed matvec); the square call is
r = c = n and keeps its bits.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: widest X block one launch takes: the square-operator PERMANOVA's tile
#: of 32 permutations x 4 groups.
KMAX = 128
#: output rows one block owns and sweeps every column for (``kBM`` of
#: ``csrc/center_matvec.cu``): a launch runs ceil(n / STRIP_ROWS) blocks.
STRIP_ROWS = 128


def center_matvec_cost(rows: int, cols: int, k: int) -> tuple[float, float]:
    """(bytes, operations) of one ``center_matvec`` launch: D read once;
    each of the ceil(rows / STRIP_ROWS) blocks reads every row of X and
    the k column sums and corrections; the row means read and the output
    stored once. Operations: E = −½d∘d, two a D element, and three tf32
    products (3xTF32), 2·rows·cols·k each."""
    blocks = -(-rows // STRIP_ROWS)
    loads = 4.0 * (rows * cols + blocks * (cols * k + 2 * k) + rows)
    return loads + 4.0 * rows * k, 6.0 * rows * cols * k + 2.0 * rows * cols


def center_matvec(d: torch.Tensor, x: torch.Tensor, row_means: torch.Tensor,
                  colsum: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """(r, k) ``E@X − r·colsumᵀ + corrᵀ`` on the card, 1 <= k <= KMAX.

    All operands fp32, contiguous, on one CUDA device: d (r, c), the
    square matrix or a block of it, x (c, k), row_means (r,), colsum and
    corr (k,). Returns without synchronising.
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
                                  cols, k, _build.stream_handle(d.device))
    _build.launches["center_matvec"] += 1
    if _build.recorder is not None:
        _build.recorder("center_matvec", *center_matvec_cost(rows, cols, k))
    _build.check(err, "center_matvec")
    return out
