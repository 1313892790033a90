"""Encoder-decoder assembly (seamless-m4t): a bidirectional encoder over
stubbed audio-frame embeddings and a causal decoder with cross-attention.

The counterpart of ``repro/models/encdec.py``. The ``EncDec`` module's tree
mirrors the reference's ``init_params_encdec``: ``embed``,
``frontend.proj``, ``enc_blocks`` (ln1, attn, ln2, mlp), ``enc_norm``,
``dec_blocks`` (ln1, self, ln_x, cross, ln2, mlp) and ``final_norm``; the
reference stacks each block list for its ``lax.scan``, the port holds one
module a layer. The decoder cache holds each layer's self-attention cache
and the cross-attention's K/V of the encoder output, computed once at
prefill and never written again (the encoder's keys do not change while
decoding). Under autograd every encoder and decoder block is checkpointed,
as the reference's unconditional ``jax.checkpoint`` around its layer
bodies; the reference's ``shard_ctx.constrain*`` and optimisation
barriers become nothing on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (MLP, Embedding, init_norm,
                                       state_device)
from repro_torch.models.transformer import (Frontend, _embed_inputs,
                                            _positions, final_norm)
from repro_torch.sharding import ctx as shard_ctx


class EncBlock(nn.Module):
    """ln1 → bidirectional self-attention → residual, ln2 → MLP →
    residual."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = init_norm(cfg, d, device)
        self.attn = attn_mod.Attention(cfg, device)
        self.ln2 = init_norm(cfg, d, device)
        self.mlp = MLP(cfg, d, cfg.d_ff, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)


class DecBlock(nn.Module):
    """ln1 → causal self-attention (``self``) → residual, ln_x →
    cross-attention to the encoder (``cross``) → residual, ln2 → MLP →
    residual."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = init_norm(cfg, d, device)
        self.add_module("self", attn_mod.Attention(cfg, device))
        self.ln_x = init_norm(cfg, d, device)
        self.cross = attn_mod.Attention(cfg, device)
        self.ln2 = init_norm(cfg, d, device)
        self.mlp = MLP(cfg, d, cfg.d_ff, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        getattr(self, "self").reset_parameters(generator)
        self.cross.reset_parameters(generator)
        self.mlp.reset_parameters(generator)


class EncDec(nn.Module):
    """The enc-dec model; parameters left uninitialised (norms at their init
    values) until ``init_params_encdec`` draws them or ``load_state_dict``
    fills them. ``device="meta"`` builds shapes and dtypes only."""

    def __init__(self, cfg, device: DeviceLike = None):
        super().__init__()
        if not cfg.is_encdec:
            raise ValueError(f"{cfg.name} is decoder-only: build it with "
                             f"models.transformer.Transformer")
        dev = (torch.device("meta") if str(device) == "meta"
               else resolve_device(device))
        self.cfg = cfg
        self.embed = Embedding(cfg, dev)
        self.frontend = Frontend(cfg, dev)
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, dev)
                                        for _ in range(cfg.n_enc_layers))
        self.enc_norm = init_norm(cfg, cfg.d_model, dev)
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, dev)
                                        for _ in range(cfg.n_layers))
        self.final_norm = init_norm(cfg, cfg.d_model, dev)

    def forward(self, frames, tokens):
        return forward_train_encdec(self, frames, tokens, self.cfg)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed.reset_parameters(generator)
        self.frontend.reset_parameters(generator)
        for block in (*self.enc_blocks, *self.dec_blocks):
            block.reset_parameters(generator)


def init_params_encdec(cfg, generator: torch.Generator,
                       device: DeviceLike = None) -> EncDec:
    """The model with weights drawn at the reference's init scales from
    ``generator``, which must lie on ``device`` (the card unless the CPU is
    asked for): the embedding, the frontend's projection, then each
    encoder and decoder layer in order."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator lies on {generator.device}, the "
                         f"parameters on {dev}: draw where they live")
    model = EncDec(cfg, dev)
    model.reset_parameters(generator)
    return model


def _blocks(fn, blocks, x, *args):
    """x through ``fn(block, x, *args)`` for each block, each checkpointed
    under autograd."""
    fn = shard_ctx.at_use(fn)
    seq_dim = 1 if args[-1].seq_shard_activations else None
    for bp in blocks:
        x = shard_ctx.constrain_batch(x, seq_dim=seq_dim)
        x = (checkpoint(fn, bp, x, *args, use_reentrant=False)
             if torch.is_grad_enabled() else fn(bp, x, *args))
    return x


def _enc_block(bp: EncBlock, x, positions, cfg):
    h, _ = attn_mod.attn_forward(bp.attn, bp.ln1(x), positions, cfg,
                                 causal=False)
    x = x + h
    return x + bp.mlp(bp.ln2(x))


def encode(params: EncDec, frames, cfg):
    """frames: (B, S_enc, frontend_dim) stub embeddings → (B, S_enc, D)."""
    with shard_ctx.gathered(params.frontend):
        x = params.frontend(frames, cfg)
    x = _blocks(_enc_block, params.enc_blocks, x, _positions(x), cfg)
    with shard_ctx.gathered(params.enc_norm):
        return params.enc_norm(x)


def _dec_block(bp: DecBlock, x, enc_out, positions, cfg):
    h, _ = attn_mod.attn_forward(bp.self, bp.ln1(x), positions, cfg,
                                 causal=True)
    x = x + h
    h, _ = attn_mod.attn_forward(bp.cross, bp.ln_x(x), None, cfg,
                                 causal=False, kv_x=enc_out,
                                 kv_positions=None)
    x = x + h
    return x + bp.mlp(bp.ln2(x))


def forward_train_encdec(params: EncDec, frames, tokens, cfg):
    """→ (decoder hidden (B,S_dec,D), aux = 0)."""
    enc_out = encode(params, frames, cfg)
    x = _embed_inputs(params, tokens, cfg)
    x = _blocks(_dec_block, params.dec_blocks, x, enc_out, _positions(x),
                cfg)
    x = shard_ctx.constrain_batch(x)
    return final_norm(params, x), torch.zeros((), dtype=torch.float32,
                                             device=x.device)


@dataclasses.dataclass
class DecLayerCache:
    """One decoder layer's cache: the self-attention's ``AttnCache`` and
    the cross-attention's K/V (B, S_enc, K, hd) of the encoder output."""
    self_attn: attn_mod.AttnCache
    cross_k: torch.Tensor
    cross_v: torch.Tensor


@dataclasses.dataclass
class EncDecCache:
    """One ``DecLayerCache`` a decoder layer, and the next token's position
    as a host int."""
    dec: list
    pos: int


@torch.no_grad()
def prefill_encdec(params: EncDec, frames, tokens, cfg,
                   max_len: Optional[int] = None):
    """Encode, run the decoder over the prompt, build the self and cross
    caches. → (hidden (B, S, D), EncDecCache)."""
    enc_out = encode(params, frames, cfg)
    x = _embed_inputs(params, tokens, cfg)
    s = x.shape[1]
    max_len = max_len or s
    positions = _positions(x)
    caches = []
    for bp in params.dec_blocks:
        x = shard_ctx.constrain_batch(x)
        with shard_ctx.gathered(bp):
            x, c = _dec_prefill(bp, x, enc_out, positions, cfg, max_len)
        caches.append(c)
    return final_norm(params, x), EncDecCache(dec=caches, pos=s)


def _dec_prefill(bp: DecBlock, x, enc_out, positions, cfg, max_len: int):
    """One decoder layer over the prompt → (x, its DecLayerCache)."""
    h, (k, v) = attn_mod.attn_forward(bp.self, bp.ln1(x), positions,
                                      cfg, causal=True)
    x = x + h
    self_cache = attn_mod.fill_cache_from_prefill(
        attn_mod.init_attn_cache(cfg, x.shape[0], max_len,
                                 device=x.device), k, v)
    h, (ck, cv) = attn_mod.attn_forward(
        bp.cross, bp.ln_x(x), None, cfg, causal=False, kv_x=enc_out,
        kv_positions=None)
    x = x + h
    x = x + bp.mlp(bp.ln2(x))
    return x, DecLayerCache(self_attn=self_cache, cross_k=ck, cross_v=cv)


def init_cache_encdec(cfg, batch: int, max_len: int, enc_len: int,
                      device: DeviceLike = None) -> EncDecCache:
    """Empty caches (zero cross K/V of ``enc_len`` positions)."""
    dev = state_device(device)
    shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
    dt = cfg.dtype("compute")
    return EncDecCache(dec=[DecLayerCache(
        self_attn=attn_mod.init_attn_cache(cfg, batch, max_len, device=dev),
        cross_k=torch.zeros(shape, dtype=dt, device=dev),
        cross_v=torch.zeros(shape, dtype=dt, device=dev))
        for _ in range(cfg.n_layers)], pos=0)


@torch.no_grad()
def decode_step_encdec(params: EncDec, token, cache: EncDecCache, cfg):
    """token: (B, 1) integers → (hidden (B,1,D), cache): each layer's self
    cache updated in place, the cross K/V read only, the position advanced
    by one."""
    pos = cache.pos
    x = _embed_inputs(params, token, cfg)
    for bp, c in zip(params.dec_blocks, cache.dec):
        x = shard_ctx.constrain_batch(x)
        with shard_ctx.gathered(bp), shard_ctx.gathered_cache(c):
            h, _ = attn_mod.attn_decode(bp.self, bp.ln1(x), c.self_attn,
                                        pos, cfg)
            x = x + h
            x = x + attn_mod.attn_decode_cross(bp.cross, bp.ln_x(x),
                                               (c.cross_k, c.cross_v), cfg)
            x = x + bp.mlp(bp.ln2(x))
    cache.pos = pos + 1
    return final_norm(params, x), cache
