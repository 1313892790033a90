"""Mixture-of-Experts FFN: top-k routing with a capacity per chunk.

The counterpart of ``repro/models/moe.py``, with its semantics kept
exactly: the sequence is taken in ``cfg.moe_chunk`` chunks (one chunk when
``s % chunk``); in each, an fp32 router and softmax pick each token's top
``k`` experts, the gates are renormalised over the k, and each (token,
choice) pair takes the next free slot of its expert in the running count
over the chunk's flattened (C, k) order. A pair past the expert's capacity
is dropped (Switch semantics), and the load-balance loss is Switch's, from
the top-1 fraction.

Where the reference builds one-hot dispatch and combine tensors
(B, C, k, E, cap) and contracts them with einsums, the port moves the
tokens with indices: the kept pairs are written into the (E, B, cap, D)
expert input by ``index_put_`` (every slot holds at most one token, so the
input is bitwise the reference's), the experts run as batched products over
E (``torch.bmm``), and each token gathers its k outputs back and sums them
weighted by its gates rounded to the compute dtype (the reference's
``comb``), in fp32, in another order than the reference's contraction over
(E, cap). At granite-moe's prefill chunk the reference's (B, C, k, E, cap)
slot tensor holds 84 M elements; the index dispatch holds (B, C, k) indices.

Top-k ties are broken as ``jax.lax.top_k`` breaks them, the lower expert
first: a stable descending sort, whose order does not depend on the
device.

On a mesh the experts are placed as the reference's rules place them
(``sharding.rules``): over "model" when E divides the axis (granite-moe,
32 experts), else over each expert FFN's hidden dim (grok, 8); the router
stays an fp32 leaf. A block gathers them when it runs, as every weight.
Routing, capacity and drops are each row's own, so they never reach a
collective; the load-balance statistics are means over the global batch,
summed over the batch axes in rank order (``sharding.ctx.batch_sum``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import draw_normal, param
from repro_torch.sharding import ctx as shard_ctx


class MoE(nn.Module):
    """router (d, E) fp32 whatever the param dtype; w_up, w_gate (E, d, f)
    and w_down (E, f, d); no w_gate for ``sq_relu``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        dt = cfg.dtype()
        self.cfg = cfg
        self.router = param((d, e), torch.float32, device)
        self.w_up = param((e, d, f), dt, device)
        self.w_down = param((e, f, d), dt, device)
        if cfg.mlp_act != "sq_relu":
            self.w_gate = param((e, d, f), dt, device)

    def forward(self, x):
        return moe_ffn(self, x, self.cfg)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, f = self.cfg.d_model, self.cfg.d_ff
        draw_normal(self.router, d ** -0.5, generator)
        if self.cfg.mlp_act != "sq_relu":
            draw_normal(self.w_gate, d ** -0.5, generator)
        draw_normal(self.w_up, d ** -0.5, generator)
        draw_normal(self.w_down, f ** -0.5, generator)


def _capacity(cfg, chunk: int) -> int:
    cap = int(chunk * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(cap, cfg.top_k)


def _expert_ffn(p: MoE, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (E, rows, D) → (E, rows, D), one product a weight batched over E."""
    if cfg.mlp_act == "sq_relu":
        h = torch.square(F.relu(torch.bmm(x, p.w_up)))
    else:
        g = torch.bmm(x, p.w_gate)
        u = torch.bmm(x, p.w_up)
        h = (F.silu(g) if cfg.mlp_act == "silu_glu"
             else F.gelu(g, approximate="tanh")) * u
    return torch.bmm(h, p.w_down)


def route(p: MoE, x: torch.Tensor, cfg):
    """x: (B, C, D) one chunk → (probs (B, C, E) fp32, ids (B, C, k),
    gates (B, C, k) fp32, pos (B, C, k), keep (B, C, k)): each pair's
    expert, renormalised gate, slot in its expert, and whether that slot is
    inside the capacity."""
    b, c, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(x.float() @ p.router, dim=-1)
    # jax.lax.top_k's order: the larger first, the lower expert on a tie
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[..., :k], ids[..., :k]
    gates = gates / gates.sum(-1, keepdim=True)
    # slot in the expert: the pairs before it in the (C, k) order that chose
    # the same expert
    oh = F.one_hot(ids, e).reshape(b, c * k, e)
    ahead = (torch.cumsum(oh, dim=1) - oh).reshape(b, c, k, e)
    pos = torch.gather(ahead, -1, ids[..., None])[..., 0]
    return probs, ids, gates, pos, pos < _capacity(cfg, c)


def _moe_chunk(p: MoE, x: torch.Tensor, cfg):
    """x: (B, C, D) one sequence chunk → ((B, C, D), aux loss)."""
    b, c, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(cfg, c)
    probs, ids, gates, pos, keep = route(p, x, cfg)

    # dispatch: kept pairs into their slots; a dropped pair is written to a
    # spare slot ``cap`` that the experts never see
    slot = torch.where(keep, pos, cap)
    rows = torch.arange(b, device=x.device)[:, None, None].expand(b, c, k)
    xin = x.new_zeros((e, b, cap + 1, d))
    xin = xin.index_put((ids, rows, slot),
                        x[:, :, None, :].expand(b, c, k, d))
    xin = xin[:, :, :cap].reshape(e, b * cap, d)
    out = _expert_ffn(p, xin, cfg).reshape(e, b, cap, d)

    # combine: each pair's output weighted by its gate rounded to the
    # compute dtype (the reference's comb), a dropped pair by 0
    got = out[ids, rows, torch.clamp(pos, max=cap - 1)]       # (B, C, k, D)
    w = torch.where(keep, gates.to(x.dtype), 0.0)
    y = torch.einsum("bck,bckd->bcd", w.float(), got.float()).to(x.dtype)

    # load-balance aux loss (Switch): E * Σ_e fraction_e * prob_e
    top1 = F.one_hot(ids[..., 0], e).sum(1).float() / c        # (B, E)
    ranks = shard_ctx.batch_ranks()
    if ranks == 1:
        frac = torch.mean(top1, dim=0)
        mean_prob = probs.mean(dim=(0, 1))
    else:       # the means over the global batch
        frac = shard_ctx.batch_sum(top1.sum(0)) / (b * ranks)
        mean_prob = shard_ctx.batch_sum(probs.sum(dim=(0, 1))) \
            / (b * c * ranks)
    aux = e * torch.sum(frac * mean_prob)
    return y, aux


def moe_ffn(p: MoE, x: torch.Tensor, cfg):
    """x: (B, S, D) → ((B, S, D), aux): chunks of ``moe_chunk`` bound the
    dispatch memory; the aux loss is the chunks' mean."""
    b, s, d = x.shape
    chunk = min(cfg.moe_chunk, s)
    if s % chunk:
        chunk = s                                   # smoke shapes
    if chunk == s:
        return _moe_chunk(p, x, cfg)
    ys, auxes = zip(*(_moe_chunk(p, x[:, i:i + chunk], cfg)
                      for i in range(0, s, chunk)))
    return torch.cat(ys, dim=1), torch.mean(torch.stack(auxes))
