"""Bray-Curtis distances of an abundance table, plain PyTorch.

d(a, b) = sum|a - b| / sum(a + b), and 0 where both samples are all zeros
(SciPy >= 1.9), for every pair, in scipy's condensed layout. A table of
counts is mostly zeros, so each row a is compared with every row b over
the features a holds: sum|a - b| = sum over a's nonzeros of (|a - b| - |b|)
plus sum|b|, which holds for any signs. Rows go in blocks, on the table's
device, each block padded to its widest row with features a lacks, which
add nothing.

Readings:

* ``dist_gap``: the widest gap between a distance the window's last
  production wrote and the reference's (fp64);
* ``studies_without_launches``: on the card, the studies whose production
  launched no kernel of the port (a session served from a cache would).

The control is the reference in TF32: the table rounded to TF32, the sums
in fp32.
"""

import torch

from perfbench.reference.precision import round_tf32

#: rows of the table one step compares with every row
ROWS = 16


def row_start(n: int, i: int) -> int:
    return i * (2 * n - i - 1) // 2


def braycurtis(table: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """The (n(n-1)/2,) condensed distances of ``table``'s rows."""
    t = table.to(dtype)
    n = t.shape[0]
    sums, abs_sums = t.sum(dim=1), t.abs().sum(dim=1)
    out = torch.empty(n * (n - 1) // 2, dtype=dtype, device=t.device)
    for i0 in range(0, n - 1, ROWS):
        a = t[i0:min(i0 + ROWS, n - 1)]
        held = a != 0
        width = max(int(held.sum(dim=1).max()), 1)
        cols = torch.argsort(held.to(torch.int8), dim=1, descending=True,
                             stable=True)[:, :width]
        a_held = torch.gather(a, 1, cols)
        b = t.index_select(1, cols.reshape(-1)).view(n, *cols.shape)
        num = (torch.abs(a_held[None] - b) - torch.abs(b)).sum(dim=-1)
        num += abs_sums[:, None]
        den = sums[i0:i0 + a.shape[0]][None, :] + sums[:, None]
        d = torch.where(den != 0, num / torch.where(den != 0, den, 1), 0)
        for j in range(a.shape[0]):
            i = i0 + j
            out[row_start(n, i):row_start(n, i + 1)] = d[i + 1:, j]
    return out


def reference(inputs: dict, args: dict, control: bool) -> torch.Tensor:
    """The condensed distances the reference (or the control) gives,
    worked out once a run and kept beside the inputs."""
    memo = ("reference.braycurtis", args["table"], control)
    if memo not in inputs:
        table = inputs[args["table"]]
        inputs[memo] = (braycurtis(round_tf32(table), torch.float32)
                        if control else braycurtis(table))
    return inputs[memo]


def judge(name, inputs, args, studies, rng, limits, control=False) -> dict:
    done = [s.outputs[name] for s in studies if s.outputs.get(name)]
    readings = {}
    if done and done[0]["launches"] is not None:
        readings["studies_without_launches"] = sum(
            out["launches"] == 0 for out in done)
    kept = [out["condensed"] for out in done
            if out.get("condensed") is not None]
    ref = reference(inputs, args, False)
    got = reference(inputs, args, True) if control else (
        kept[-1] if kept else None)
    if got is None or got.shape != ref.shape:
        readings["dist_gap"] = float("inf")
    else:
        readings["dist_gap"] = float((got.double() - ref).abs().max())
    return readings
