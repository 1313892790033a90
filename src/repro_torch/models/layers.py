"""Shared layers: norms, rotary embeddings, MLP variants, embedding/head.

The counterpart of ``repro/models/layers.py``, with the parameters held in
``nn.Module``s whose tensors keep the reference's layouts (``w_up`` is
(d, d_ff), the embedding table (vocab, d)), so a converted reference
pytree loads as it is (``repro_torch.convert.lm_params_from_reference``).

Numerics follow the reference: bf16 params/activations with fp32 norm
statistics, fp32 softmax, fp32 rotary. One difference by design:
``RMSNorm`` computes the fused kernel's function (``kernels/rmsnorm_ops.py``,
the twin the reference's docstring names), which rounds once at the store;
the reference's jnp ``rmsnorm`` casts the inverse RMS to bf16 and rounds
three times. The two are equal in fp32 up to the order of the sum
(ROADMAP.md, queue 3, records the bf16 bound).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.rmsnorm_ops import rmsnorm_op
from repro_torch.sharding import ctx as shard_ctx


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------
def state_device(device) -> torch.device:
    """Where a cache is made: ``"meta"`` (shapes and dtypes only, the
    serving layer's ``abstract_cache``), else ``resolve_device``'s."""
    return (torch.device("meta") if str(device) == "meta"
            else resolve_device(device))


def param(shape, dtype, device, fill=None) -> nn.Parameter:
    """A parameter of ``shape``: uninitialised, or filled with ``fill``."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t)


@torch.no_grad()
def draw_normal(p: torch.Tensor, scale: float,
                generator: torch.Generator) -> None:
    """``p ← (normal · scale).astype(p.dtype)``, the reference's init: an
    fp32 draw scaled in fp32, rounded once into ``p``. The generator must
    lie on ``p``'s device."""
    p.copy_(torch.randn(p.shape, dtype=torch.float32, device=p.device,
                        generator=generator) * scale)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """The reference's bf16-pure data path: fp32 one-pass moments only."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    ex2 = torch.mean(xf * xf, dim=-1, keepdim=True)
    var = torch.clamp_min(ex2 - mu * mu, 0.0)
    y = (x - mu.to(x.dtype)) * torch.rsqrt(var + eps).to(x.dtype)
    return y * w.to(x.dtype) + b.to(x.dtype)


class RMSNorm(nn.Module):
    """'1 + w' RMSNorm; ``w`` starts at 0. fp32 statistics, one rounding to
    x's dtype: the ``rmsnorm`` kernel on a CUDA tensor, its plain version on
    a CPU tensor; under autograd through ``RMSNormFunction``, whose backward
    is the ``rmsnorm_bwd`` kernel on the card."""

    def __init__(self, d: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.w = param((d,), dtype, device, fill=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm_op(x, self.w)


class LayerNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.w = param((d,), dtype, device, fill=1.0)
        self.b = param((d,), dtype, device, fill=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.w, self.b)


def init_norm(cfg, d: int, device=None) -> nn.Module:
    cls = LayerNorm if cfg.norm == "layernorm" else RMSNorm
    return cls(d, cfg.dtype(), device)


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integers. fp32 rotation,
    cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)            # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLP variants
# --------------------------------------------------------------------------
class MLP(nn.Module):
    """Gated (``silu_glu``, ``gelu_glu``) or squared-ReLU (``sq_relu``)."""

    def __init__(self, cfg, d: int, d_ff: int, device=None):
        super().__init__()
        dt = cfg.dtype()
        self.act = cfg.mlp_act
        if self.act != "sq_relu":
            self.w_gate = param((d, d_ff), dt, device)
        self.w_up = param((d, d_ff), dt, device)
        self.w_down = param((d_ff, d), dt, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act == "sq_relu":
            h = torch.square(F.relu(x @ self.w_up))
        else:
            g = x @ self.w_gate
            u = x @ self.w_up
            h = (F.silu(g) if self.act == "silu_glu"
                 else F.gelu(g, approximate="tanh")) * u
        return h @ self.w_down

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, d_ff = self.w_up.shape
        if self.act != "sq_relu":
            draw_normal(self.w_gate, d ** -0.5, generator)
        draw_normal(self.w_up, d ** -0.5, generator)
        draw_normal(self.w_down, d_ff ** -0.5, generator)


# --------------------------------------------------------------------------
# Embedding / LM head
# --------------------------------------------------------------------------
class Embedding(nn.Module):
    """The token table and, when the head is untied, the head."""

    def __init__(self, cfg, device=None):
        super().__init__()
        shape = (cfg.vocab, cfg.d_model)
        self.table = param(shape, cfg.dtype(), device)
        self.head = None if cfg.tie_embeddings else \
            param(shape, cfg.dtype(), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        scale = self.table.shape[1] ** -0.5
        draw_normal(self.table, scale, generator)
        if self.head is not None:
            draw_normal(self.head, scale, generator)


def embed_tokens(e: Embedding, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """tokens (B, S) integers → (B, S, D): a row gather. It equals the
    reference's one-hot einsum bitwise (each one-hot row holds a single 1),
    in the dtype that einsum promotes to. On a mesh whose TP axis splits
    the vocab, each rank gathers the tokens of its slice (zeros for the
    others) and the rows are summed over the axis, as the reference's
    einsum against a vocab-sharded table partitions: one term of each sum
    is not zero, so the sum is exact."""
    table, v0 = shard_ctx.vocab_rows(e, "table")
    dt = torch.promote_types(cfg.dtype("compute"), table.dtype)
    if table.shape[0] == cfg.vocab:
        return table[tokens.long()].to(dt)
    t = tokens.long() - v0
    mine = ((t >= 0) & (t < table.shape[0]))[..., None]
    rows = table[t.clamp(0, table.shape[0] - 1)].to(dt)
    return shard_ctx.tp_sum(torch.where(mine, rows, 0.0))


def lm_logits(e: Embedding, x: torch.Tensor, cfg) -> torch.Tensor:
    """x @ table.T (the head's when it is untied); on a mesh whose TP axis
    splits the vocab, each rank's slice, gathered over the axis."""
    table, _ = shard_ctx.vocab_rows(e, "table" if cfg.tie_embeddings
                                    else "head")
    logits = x @ table.T
    if table.shape[0] != cfg.vocab:
        logits = shard_ctx.tp_gather(logits, dim=logits.ndim - 1)
    return logits
