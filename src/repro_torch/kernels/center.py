"""Launch of the two-pass centering CUDA kernels (``csrc/center.cu``).

Replaces the Pallas kernels ``repro/kernels/center.py::center_pass1`` and
``center_pass2``. The Pallas pass 1 writes E and carries the row sums and
the global sum across an in-order grid; here

* ``center_pass1`` — a warp owns a row and writes the row sum of
  E = −½D∘D; E itself is never written;
* ``center_finish`` — one block sums the n row sums in a fixed order
  (fp64) into the global mean and writes the row means;
* ``center_pass2`` — forms E again in registers and writes
  F = E − r_i − r_j + m with 16-byte accesses.

No atomics anywhere, so F is reproducible bit for bit. D and F are fp32,
or bf16 with fp32 arithmetic inside.

Both passes also take an (r, c) block of D (block mode, for the
distributed centering): pass 1 its r row sums, pass 2 its F block from
its r row means and c column means. The square call is r = c = n with
the row means as the column means, and gives the same bits.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build


def center_pass1(d: torch.Tensor) -> torch.Tensor:
    """(r,) fp32 row sums of ``E = −½ d∘d`` for an (r, c) contiguous fp32
    or bf16 ``d`` on the card: the square matrix, or a block of it.
    Returns without synchronising."""
    rows, cols = d.shape
    row_sums = torch.empty((rows,), dtype=torch.float32, device=d.device)
    err = _build.library().repro_center_pass1(
        d.data_ptr(), row_sums.data_ptr(), rows, cols,
        int(d.dtype == torch.bfloat16), _build.stream_handle(d.device))
    _build.launches["center_pass1"] += 1
    _build.check(err, "center_pass1")
    return row_sums


def center_finish(row_sums: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(row_means, global_mean)`` of E from its (n,) fp32 row sums: the
    row means (n,) and the global mean, a (1,) fp32 tensor. Returns
    without synchronising."""
    n = row_sums.shape[0]
    row_means = torch.empty_like(row_sums)
    global_mean = torch.empty((1,), dtype=torch.float32,
                              device=row_sums.device)
    err = _build.library().repro_center_finish(
        row_sums.data_ptr(), row_means.data_ptr(), global_mean.data_ptr(), n,
        _build.stream_handle(row_sums.device))
    _build.launches["center_finish"] += 1
    _build.check(err, "center_finish")
    return row_means, global_mean


def center_pass2(d: torch.Tensor, row_means: torch.Tensor,
                 global_mean: torch.Tensor,
                 col_means: Optional[torch.Tensor] = None) -> torch.Tensor:
    """F = E − r_i − c_j + m, of ``d``'s dtype, for an (r, c) contiguous
    fp32 or bf16 ``d`` on the card, given fp32 row means (r,), column means
    (c,) and global mean (1,). ``col_means=None`` is the square matrix's
    call, whose column means are its row means. Returns without
    synchronising."""
    rows, cols = d.shape
    col_means = row_means if col_means is None else col_means
    f = torch.empty_like(d)
    err = _build.library().repro_center_pass2(
        d.data_ptr(), row_means.data_ptr(), col_means.data_ptr(),
        global_mean.data_ptr(), f.data_ptr(), rows, cols,
        int(d.dtype == torch.bfloat16), _build.stream_handle(d.device))
    _build.launches["center_pass2"] += 1
    _build.check(err, "center_pass2")
    return f
