"""Decoder-only transformer: ``attn``, ``local``, ``moe``, ``rec`` and ``ssd``
blocks, and the vision frontend.

The counterpart of ``repro/models/transformer.py``. Where the reference
stacks each pattern position's params (n_periods, ...) for ``lax.scan`` and
runs remainder layers unrolled, the port holds one ``Block`` a layer in an
``nn.ModuleList``, in the order ``cfg.layer_types()`` gives: the order the
reference's scan and remainder visit them. ``forward_train`` is the
training forward: under autograd every block is rematerialised as
``cfg.remat`` says (the reference's ``_remat`` around its layer scan):
``"full"`` checkpoints each block (``torch.utils.checkpoint``, non-reentrant:
only its input is kept and the block runs again in the backward),
``"dots"`` keeps the outputs of the blocks' matrix products (``aten.mm``,
``aten.addmm``: the products with no batch dimension, as
``checkpoint_dots_with_no_batch_dims`` keeps) and recomputes the rest, and
``"none"`` keeps every activation. Rematerialisation changes what is kept,
not what is computed. The reference's ``sharding/ctx.constrain*`` calls
stand where they stand there and move nothing (the rank holds its rows).
On a mesh (``sharding.ctx.use_shards``) each block's weights are gathered
when it runs (``ctx.at_use``), in a remat block's backward again, and a
sharded cache's tensors are gathered for the layer that reads them
(``ctx.gathered_cache``); with no shards registered both are nothing.

Three entry points with the reference's signatures, ``params`` being the
``Transformer``:
  forward_train  — full-sequence causal forward → final hidden states
  prefill        — forward + cache construction (inference)
  decode_step    — one token through all layers against the cache

``local`` blocks attend within ``cfg.window`` and keep a ring cache;
``moe`` blocks replace the MLP with ``models/moe.py``'s FFN, whose
load-balance loss ``forward_train`` sums over the layers; ``rec`` blocks
(recurrentgemma) put the RG-LRU mixer of ``models/rglru.py`` where the
attention is, and keep its conv inputs and state as their cache; ``ssd``
blocks (mamba2) are one norm and the SSD mixer of ``models/ssd.py``, with
no MLP. Every cache is updated in place by a decode step. A vision model
(``cfg.frontend == "vision"``) projects ``extra_embeds`` (B, n_patches,
frontend_dim) through ``frontend.proj`` and puts them before the token
embeddings; only the tokens are scaled by √d. Enc-dec models are
``models/encdec.py``'s ``EncDec``. ``init_params`` draws from an explicit
``torch.Generator`` on the parameters' device: not key-compatible with JAX
(the parity tests load the reference's weights through
``repro_torch.convert.lm_params_from_reference``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rec_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.layers import (MLP, Embedding, draw_normal,
                                       embed_tokens, init_norm, param,
                                       state_device)
from repro_torch.sharding import ctx as shard_ctx

PORTED_BLOCKS = ("attn", "local", "moe", "rec", "ssd")


def _check_block(btype: str) -> None:
    if btype not in PORTED_BLOCKS:
        raise ValueError(f"unknown block type {btype!r}; the block types "
                         f"are {PORTED_BLOCKS}")


# --------------------------------------------------------------------------
# the block module and its forward / prefill / decode
# --------------------------------------------------------------------------
class Block(nn.Module):
    """One layer. ``attn``/``local``/``moe``: ln1 → attention → residual,
    ln2 → MLP (``moe``: the MoE FFN) → residual. ``rec``: ln1 → RG-LRU
    mixer → residual, ln2 → MLP → residual. ``ssd``: ln → SSD mixer →
    residual."""

    def __init__(self, cfg, btype: str = "attn", device=None):
        super().__init__()
        _check_block(btype)
        d = cfg.d_model
        self.cfg = cfg
        self.btype = btype
        if btype == "ssd":
            self.ln = init_norm(cfg, d, device)
            self.ssd = ssd_mod.SSD(cfg, device)
            return
        self.ln1 = init_norm(cfg, d, device)
        if btype == "rec":
            self.rec = rec_mod.Rec(cfg, device)
        else:
            self.attn = attn_mod.Attention(cfg, device)
        self.ln2 = init_norm(cfg, d, device)
        if btype == "moe":
            self.moe = moe_mod.MoE(cfg, device)
        else:
            self.mlp = MLP(cfg, d, cfg.d_ff, device)

    def forward(self, x, positions):
        return block_forward(self, x, positions, self.cfg, self.btype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.btype == "ssd":
            self.ssd.reset_parameters(generator)
            return
        (self.rec if self.btype == "rec" else self.attn).reset_parameters(
            generator)
        (self.moe if self.btype == "moe" else self.mlp).reset_parameters(
            generator)


def _window(cfg, btype: str) -> int:
    return cfg.window if btype == "local" else 0


def _ffn(p: Block, x, cfg, btype: str):
    """ln2 → MLP or MoE → (h, aux_loss)."""
    if btype == "moe":
        return moe_mod.moe_ffn(p.moe, p.ln2(x), cfg)
    return p.mlp(p.ln2(x)), _zero(x)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def block_forward(p: Block, x, positions, cfg, btype: str):
    """→ (x, aux_loss)."""
    _check_block(btype)
    if btype == "ssd":
        h, _ = ssd_mod.ssd_forward(p.ssd, p.ln(x), cfg)
        return x + h, _zero(x)
    if btype == "rec":
        h, _ = rec_mod.rec_forward(p.rec, p.ln1(x), cfg)
    else:
        h, _ = attn_mod.attn_forward(p.attn, p.ln1(x), positions, cfg,
                                     window=_window(cfg, btype))
    x = x + h
    h, aux = _ffn(p, x, cfg, btype)
    return x + h, aux


def init_block_cache(cfg, btype: str, batch: int, max_len: int,
                     device=None):
    """An empty cache of one layer: an ``AttnCache`` (a ring for ``local``),
    a ``RecCache`` or an ``SSDCache``."""
    _check_block(btype)
    if btype == "rec":
        return rec_mod.init_rec_cache(cfg, batch, device)
    if btype == "ssd":
        return ssd_mod.init_ssd_cache(cfg, batch, device)
    return attn_mod.init_attn_cache(cfg, batch, max_len,
                                    window=_window(cfg, btype), device=device)


def block_prefill(p: Block, x, positions, cfg, btype: str, max_len: int):
    """→ (x, cache). Like forward but keeps the inference cache."""
    _check_block(btype)
    if btype == "ssd":
        h, cache = ssd_mod.ssd_forward(p.ssd, p.ln(x), cfg)
        return x + h, cache
    if btype == "rec":
        h, (conv, h_last) = rec_mod.rec_forward(p.rec, p.ln1(x), cfg)
        cache = rec_mod.RecCache(conv=conv, h=h_last)
    else:
        window = _window(cfg, btype)
        h, (k, v) = attn_mod.attn_forward(p.attn, p.ln1(x), positions, cfg,
                                          window=window)
        cache = attn_mod.init_attn_cache(cfg, x.shape[0], max_len,
                                         window=window, device=x.device)
        cache = attn_mod.fill_cache_from_prefill(cache, k, v, window=window)
    x = x + h
    return x + _ffn(p, x, cfg, btype)[0], cache


def block_decode(p: Block, x, cache, pos: int, cfg, btype: str):
    """→ (x, cache). x: (B, 1, D); the cache is updated in place."""
    _check_block(btype)
    if btype == "ssd":
        h, cache = ssd_mod.ssd_decode(p.ssd, p.ln(x), cache, cfg)
        return x + h, cache
    if btype == "rec":
        h, cache = rec_mod.rec_decode(p.rec, p.ln1(x), cache, cfg)
    else:
        h, cache = attn_mod.attn_decode(p.attn, p.ln1(x), cache, pos, cfg,
                                        window=_window(cfg, btype))
    x = x + h
    return x + _ffn(p, x, cfg, btype)[0], cache


# --------------------------------------------------------------------------
# the stack
# --------------------------------------------------------------------------
class Frontend(nn.Module):
    """The modality frontend stub: ``proj`` (frontend_dim, d_model) folds
    precomputed patch (vision) or frame (audio) embeddings into the model's
    width."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.proj = param((cfg.frontend_dim, cfg.d_model), cfg.dtype(),
                          device)

    def forward(self, embeds, cfg) -> torch.Tensor:
        """(B, P, frontend_dim) embeddings in the compute dtype through
        ``proj``, in the dtype the two promote to (the reference's
        einsum)."""
        e = torch.as_tensor(embeds, device=self.proj.device).to(
            cfg.dtype("compute"))
        dt = torch.promote_types(e.dtype, self.proj.dtype)
        return e.to(dt) @ self.proj.to(dt)

    def reset_parameters(self, generator: torch.Generator) -> None:
        draw_normal(self.proj, self.proj.shape[0] ** -0.5, generator)


class Transformer(nn.Module):
    """embed → blocks (one a layer) → final_norm, and ``frontend`` for a
    vision model. Parameters are left uninitialised (norms and biases at
    their init values): ``init_params`` draws them, ``load_state_dict``
    fills them. ``device="meta"`` builds shapes and dtypes only
    (``runtime.train.abstract_train_state``)."""

    def __init__(self, cfg, device: DeviceLike = None):
        super().__init__()
        if cfg.is_encdec:
            raise ValueError(f"{cfg.name} is an enc-dec model: build it "
                             f"with models.encdec.EncDec")
        if cfg.frontend not in ("none", "vision"):
            raise ValueError(f"a decoder-only model takes the vision "
                             f"frontend or none, not {cfg.frontend!r}")
        dev = (torch.device("meta") if str(device) == "meta"
               else resolve_device(device))
        self.cfg = cfg
        self.embed = Embedding(cfg, dev)
        self.blocks = nn.ModuleList(Block(cfg, t, dev)
                                    for t in cfg.layer_types())
        self.final_norm = init_norm(cfg, cfg.d_model, dev)
        if cfg.frontend == "vision":
            self.frontend = Frontend(cfg, dev)

    def forward(self, tokens, extra_embeds=None):
        return forward_train(self, tokens, self.cfg, extra_embeds)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed.reset_parameters(generator)
        for block in self.blocks:
            block.reset_parameters(generator)
        if self.cfg.frontend == "vision":
            self.frontend.reset_parameters(generator)


def init_params(cfg, generator: torch.Generator,
                device: DeviceLike = None) -> Transformer:
    """The full model with weights drawn at the reference's init scales
    (``layers.py``, ``attention.py``, ``moe.py``, ``rglru.py``, ``ssd.py``):
    the embedding, then each layer's mixer and MLP or MoE in order, then
    the frontend's projection, from ``generator``, which must lie on
    ``device`` (the card unless the CPU is asked for)."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator lies on {generator.device}, the "
                         f"parameters on {dev}: draw where they live")
    model = Transformer(cfg, dev)
    model.reset_parameters(generator)
    return model


@dataclasses.dataclass
class LMCache:
    """One cache a layer (``AttnCache``, ``RecCache`` or ``SSDCache``), and
    the next token's position as a host int (the reference keeps it as a
    device scalar)."""
    blocks: list
    pos: int


def _embed_inputs(params: Transformer, tokens, cfg, extra_embeds=None):
    x = embed_tokens(params.embed, tokens, cfg)
    # the scale rounded to x's dtype before the multiply, as the reference's
    # jnp.asarray(d ** 0.5, x.dtype); the product of two bf16 values is exact
    # in the fp32 torch computes it in, so it is rounded once, as there
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=torch.float64).to(
        x.dtype).item()
    x = x * scale
    if cfg.frontend != "none" and extra_embeds is not None:
        # the patches through the projection, unscaled, before the tokens
        with shard_ctx.gathered(params.frontend):
            patches = params.frontend(extra_embeds, cfg)
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    return x


def final_norm(params, x):
    """The model's final norm, its weight gathered on a mesh."""
    with shard_ctx.gathered(params.final_norm):
        return params.final_norm(x)


def _positions(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[1], dtype=torch.int32,
                        device=x.device).expand(x.shape[:2])


#: the ops whose outputs ``remat="dots"`` keeps: the blocks' matrix products
#: with no batch dimension (the projections and the MLP; the attention
#: einsums are batched ``bmm``s and are recomputed).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg):
    """``fn`` under the rematerialisation ``cfg.remat`` names."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        return lambda *args: checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(
                _keep_dots))
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def forward_train(params: Transformer, tokens, cfg, extra_embeds=None):
    """→ (hidden (B,S,D), aux_loss), S counting the patches of a vision
    model. The layers of the reference's scan (whole pattern periods) are
    rematerialised as ``cfg.remat`` says; the remainder layers, the
    embedding and the final norm are not, as there."""
    x = _embed_inputs(params, tokens, cfg, extra_embeds)
    positions = _positions(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    scanned = cfg.n_layers - cfg.n_layers % len(cfg.pattern)
    seq_dim = 1 if cfg.seq_shard_activations else None
    at_use = shard_ctx.at_use(block_forward)
    remat_block = _remat(at_use, cfg)
    for i, (btype, bp) in enumerate(zip(cfg.layer_types(), params.blocks)):
        x = shard_ctx.constrain_batch(x, seq_dim=seq_dim)
        block = remat_block if i < scanned else at_use
        x, a = block(bp, x, positions, cfg, btype)
        aux = aux + a
    x = shard_ctx.constrain_batch(x)
    return final_norm(params, x), aux


@torch.no_grad()
def prefill(params: Transformer, tokens, cfg, extra_embeds=None,
            max_len: Optional[int] = None):
    """→ (hidden, cache). max_len: cache capacity (≥ prompt length, the
    patches of a vision model included)."""
    x = _embed_inputs(params, tokens, cfg, extra_embeds)
    max_len = max_len or x.shape[1]
    positions = _positions(x)
    caches = []
    for btype, bp in zip(cfg.layer_types(), params.blocks):
        x = shard_ctx.constrain_batch(x)
        with shard_ctx.gathered(bp):
            x, c = block_prefill(bp, x, positions, cfg, btype, max_len)
        caches.append(c)
    cache = LMCache(blocks=caches, pos=x.shape[1])
    return final_norm(params, x), cache


def init_cache(cfg, batch: int, max_len: int,
               device: DeviceLike = None) -> LMCache:
    """Empty cache (decode from scratch)."""
    dev = state_device(device)
    return LMCache(blocks=[init_block_cache(cfg, t, batch, max_len, dev)
                           for t in cfg.layer_types()], pos=0)


@torch.no_grad()
def decode_step(params: Transformer, token, cache: LMCache, cfg):
    """token: (B, 1) integers → (hidden (B,1,D), cache), the cache updated
    in place and its position advanced by one."""
    pos = cache.pos
    x = _embed_inputs(params, token, cfg)
    for i, (btype, bp) in enumerate(zip(cfg.layer_types(), params.blocks)):
        x = shard_ctx.constrain_batch(x)
        with shard_ctx.gathered(bp), shard_ctx.gathered_cache(cache.blocks[i]):
            x, _ = block_decode(bp, x, cache.blocks[i], pos, cfg, btype)
    cache.pos = pos + 1
    return final_norm(params, x), cache
