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
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def center_pass1(d: torch.Tensor) -> torch.Tensor:
    """(n,) fp32 row sums of ``E = −½ d∘d`` for a square fp32 or bf16
    ``d`` on the card. Returns without synchronising."""
    n = d.shape[0]
    row_sums = torch.empty((n,), dtype=torch.float32, device=d.device)
    err = _build.library().repro_center_pass1(
        d.data_ptr(), row_sums.data_ptr(), n, int(d.dtype == torch.bfloat16),
        _build.stream_handle(d.device))
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
                 global_mean: torch.Tensor) -> torch.Tensor:
    """F = E − r_i − r_j + m, of ``d``'s dtype, for a square fp32 or bf16
    ``d`` on the card, given fp32 row means (n,) and global mean (1,).
    Returns without synchronising."""
    n = d.shape[0]
    f = torch.empty_like(d)
    err = _build.library().repro_center_pass2(
        d.data_ptr(), row_means.data_ptr(), global_mean.data_ptr(),
        f.data_ptr(), n, int(d.dtype == torch.bfloat16),
        _build.stream_handle(d.device))
    _build.launches["center_pass2"] += 1
    _build.check(err, "center_pass2")
    return f
