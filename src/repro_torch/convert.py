"""Carry state from the reference package into the port.

The system has no weights: what crosses from ``repro`` (JAX) to
``repro_torch`` is data and the few quantities that JAX draws with its own
random numbers, which torch cannot reproduce. The reference's arrays are
taken as numpy (``np.asarray(jax_array)``) and become tensors of the port's
dtypes on the chosen device. This is the whole of the transfer; it is how
both packages compute on the same inputs in the parity tests.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.dispatch import DeviceLike, resolve_device

#: what each key of the reference's state is, and its dtype in the port.
STATE_DTYPES = {
    "data": torch.float32,       # square (n, n) distance matrix
    "condensed": torch.float32,  # (m,) condensed distances
    "orders": torch.int32,       # (K, n) permutation orders
    "omega": torch.float32,      # (n, p) PCoA range-finder sketch
    "xc": torch.float32,         # (m,) hoisted condensed x (Mantel)
    "ynorm": torch.float32,      # (m,) hoisted centred-normalised y (Mantel)
    "normxm": torch.float32,     # () hoisted centred norm of x (Mantel)
}


def from_reference(state: dict[str, np.ndarray],
                   device: DeviceLike = None) -> dict[str, torch.Tensor]:
    """The port's tensors for the reference's ``state`` arrays."""
    dev = resolve_device(device)
    unknown = set(state) - set(STATE_DTYPES)
    if unknown:
        raise KeyError(f"unknown state keys {sorted(unknown)}; expected "
                       f"some of {sorted(STATE_DTYPES)}")
    return {key: torch.from_numpy(np.array(value, copy=True)).to(
                device=dev, dtype=STATE_DTYPES[key]).contiguous()
            for key, value in state.items()}
