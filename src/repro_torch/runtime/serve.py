"""Serving step builders: batched prefill and single-token decode.

The counterpart of ``repro/runtime/serve.py::build_prefill_fn`` and
``build_decode_fn``, with the reference's signatures: ``params`` is the
``Transformer`` (or, for an enc-dec config, the ``EncDec``), ``batch`` a
dict holding ``"tokens"`` (B, S), and each step returns ``(logits,
cache)``. Prefill returns only the last position's
logits; decode updates the cache in place (the reference's jitted decode
donates it) and returns it.

The builders resolve the device once: the card unless ``device="cpu"``,
raising when there is no card. A vision model's prefill takes the patch
embeddings as ``batch["patches"]`` (B, n_patches, frontend_dim); an enc-dec
model's takes the audio frame embeddings as ``batch["frames"]`` (B, S_enc,
frontend_dim). ``repro_torch.models`` hands each step to the config's
family. The sharded ``make_prefill_step`` and ``make_decode_step`` (a mesh
and its shardings) wait for the distributed slice (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import torch

from repro_torch import models
from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.models.layers import lm_logits


def _on(params, dev: torch.device, array):
    """The tokens (or patches, or frames) as a tensor on ``dev``; raise unless the
    model lies there."""
    where = params.embed.table.device
    if where.type != dev.type:
        raise ValueError(f"the model lies on {where}, the step was built "
                         f"for {dev}")
    return torch.as_tensor(array, device=where)


def build_prefill_fn(cfg, max_len: int, device: DeviceLike = None):
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch):
        extra = models.extra_input(cfg, batch)
        hidden, cache = models.prefill(
            params, _on(params, dev, batch["tokens"]), cfg,
            None if extra is None else _on(params, dev, extra),
            max_len=max_len)
        # only the last position's logits are needed to start decoding
        return lm_logits(params.embed, hidden[:, -1:], cfg), cache

    return prefill_step


def build_decode_fn(cfg, device: DeviceLike = None):
    dev = resolve_device(device)

    @torch.no_grad()
    def decode_step(params, token, cache):
        hidden, cache = models.decode_step(params, _on(params, dev, token),
                                           cache, cfg)
        return lm_logits(params.embed, hidden, cfg), cache

    return decode_step
