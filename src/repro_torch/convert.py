"""Carry state from the reference package into the port.

The analyses have no weights: what crosses from ``repro`` (JAX) to
``repro_torch`` is data and the few quantities that JAX draws with its own
random numbers, which torch cannot reproduce. The reference's arrays are
taken as numpy (``np.asarray(jax_array)``) and become tensors of the port's
dtypes on the chosen device (``from_reference``). The LM stack's weights
and optimizer state cross the same way (``lm_params_from_reference``,
``opt_state_from_reference``). This is the whole of the
transfer; it is how both packages compute on the same inputs in the parity
tests.
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


def _lm_leaves(tree_np: dict, cfg, dtype_of,
               dev: torch.device) -> dict[str, torch.Tensor]:
    """The port's state_dict keys for a pytree laid out as the reference's
    ``init_params``, each leaf a tensor of ``dtype_of(key)`` on ``dev``."""
    period = len(cfg.pattern)
    n_full = cfg.n_layers // period

    def leaves(tree: dict, prefix: str = ""):
        for key, value in tree.items():
            if isinstance(value, dict):
                yield from leaves(value, f"{prefix}{key}.")
            else:
                yield f"{prefix}{key}", value

    def named():
        for top in ("embed", "final_norm", "frontend", "enc_norm"):
            yield from leaves(tree_np.get(top, {}), f"{top}.")
        if cfg.is_encdec:
            for group, n in (("enc_blocks", cfg.n_enc_layers),
                             ("dec_blocks", cfg.n_layers)):
                for name, value in leaves(tree_np[group]):
                    for i in range(n):
                        yield f"{group}.{i}.{name}", value[i]
            return
        for j, stacked in enumerate(tree_np["blocks"]):
            for name, value in leaves(stacked):
                for i in range(n_full):
                    yield f"blocks.{i * period + j}.{name}", value[i]
        for r, block in enumerate(tree_np["rem"]):
            yield from leaves(block, f"blocks.{n_full * period + r}.")

    return {key: torch.from_numpy(np.array(a, dtype=np.float32)).to(
                device=dev, dtype=dtype_of(key))
            for key, a in named()}


#: the leaves that are fp32 whatever the param dtype, in both packages: the
#: MoE routers, the SSD's Δ bias, A and skip, and the RG-LRU's Λ.
FP32_LEAVES = ("moe.router", "ssd.dt_bias", "ssd.a_log", "ssd.d_skip",
               "rec.lambda")


def lm_params_from_reference(params_np: dict, cfg,
                             device: DeviceLike = None
                             ) -> dict[str, torch.Tensor]:
    """The port's ``Transformer`` (or, for an enc-dec config, ``EncDec``)
    state_dict for the reference's ``models/transformer.py::init_params``
    (``models/encdec.py::init_params_encdec``) pytree, taken as numpy
    (``jax.tree.map(np.asarray, params)``).

    The reference stacks each pattern position's block params (n_full, ...)
    for its scan and keeps the remainder layers apart; layer
    ``i·period + j`` is row i of pattern position j, and remainder layer r
    is layer ``n_full·period + r`` (recurrentgemma-9b: 12 periods of (rec,
    rec, local), then (rec, rec)). An enc-dec tree stacks every encoder and
    every decoder layer; layer i is row i. Each leaf becomes a tensor of
    the config's param dtype (bf16 arrives as float32, exactly), but for
    ``FP32_LEAVES``, which are fp32 whatever the param dtype, as there."""
    def dtype_of(key: str) -> torch.dtype:
        return torch.float32 if key.endswith(FP32_LEAVES) else cfg.dtype()
    return _lm_leaves(params_np, cfg, dtype_of, resolve_device(device))


def opt_state_from_reference(opt_np: dict, model, cfg,
                             device: DeviceLike = None) -> dict:
    """The port's AdamW state (``repro_torch.optim.adamw``) for the
    reference's ``init_opt_state`` / ``adamw_update`` state
    ``{"m", "v", "step"}`` taken as numpy: the moments laid out as
    ``model``'s parameters, in ``cfg.dtype("opt")``, and the step as an
    int32 0-d tensor, so both packages start a step from the same state."""
    dev = resolve_device(device)
    names = {name for name, _ in model.named_parameters()}
    out = {}
    for key in ("m", "v"):
        out[key] = _lm_leaves(opt_np[key], cfg, lambda _: cfg.dtype("opt"),
                              dev)
        if set(out[key]) != names:
            raise KeyError(f"the reference's {key!r} and the model name "
                           f"different leaves: "
                           f"{sorted(set(out[key]) ^ names)}")
    out["step"] = torch.tensor(int(np.asarray(opt_np["step"])),
                               dtype=torch.int32, device=dev)
    return out
