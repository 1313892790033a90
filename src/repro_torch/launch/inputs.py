"""``input_specs()``: stand-ins for every model input on the ``meta``
device (shapes and dtypes, no memory).

The counterpart of ``repro/launch/inputs.py``, with its shapes and dtypes:
tokens and targets int32, the vision frontend's precomputed patch
embeddings and the audio frontend's precomputed frame embeddings bf16 (the
modality frontends are stubs in both packages), and the decode cache from
``runtime.serve.abstract_cache``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.runtime.serve import abstract_cache


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    specs = {}
    if cfg.is_encdec:
        specs["frames"] = _meta((b, s // cfg.enc_len_ratio, cfg.frontend_dim),
                                torch.bfloat16)
    elif cfg.frontend == "vision":
        # the patches fold into the sequence: text fills the remainder
        s = s - cfg.n_patches
        specs["patches"] = _meta((b, cfg.n_patches, cfg.frontend_dim),
                                 torch.bfloat16)
    specs["tokens"] = _meta((b, s), torch.int32)
    specs["targets"] = _meta((b, s), torch.int32)
    return specs


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    specs = train_input_specs(cfg, shape)
    specs.pop("targets")
    return specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """→ (token, cache): the cache ``shape.seq_len`` slots deep."""
    b, s = shape.global_batch, shape.seq_len
    token = _meta((b, 1), torch.int32)
    enc_len = (s // cfg.enc_len_ratio) if cfg.is_encdec else 0
    return token, abstract_cache(cfg, b, s, enc_len=enc_len)


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)
