"""Attention: GQA/MQA/MHA with RoPE, qk-norm, QKV bias, logit softcap,
sliding windows and cross-attention.

The counterpart of ``repro/models/attention.py``, computed as the reference computes it: products through
``torch.einsum``/``matmul``, scores cast to fp32, masked scores set to
``_NEG_INF`` (not ``-inf``), an fp32 softmax, and the probabilities cast to
q's dtype before the PV product. No fused attention library is called.

* ``attn_forward`` takes one masked pass while S <= max(attn_chunk, 2048)
  and loops over query chunks of ``attn_chunk`` above it, so the live
  scores buffer is (chunk, S) (the reference's ``lax.scan``); a window
  (``local`` blocks) narrows the causal mask in both;
* prefill expands K/V to the full head count (``repeat_interleave``, the
  reference's ``jnp.repeat``); decode uses the grouped (K, G) product. Both
  map query head h to kv head h // G;
* the cache is updated in place (the reference's ``dynamic_update_slice``
  returns a new one; its jitted decode donates the old). The decode
  position is a host ``int``: no host sync a layer. The slot-validity mask
  is built on the device from the cache's ``pos`` slot array;
* a window makes the cache a ring of ``min(window, max_len)`` slots:
  position t lives in slot ``t % size``;
* ``kv_quant`` stores K/V as int8 with one fp32 scale per (b, t, head)
  (``max|x| / 127``); decode dequantizes the whole cache to x's dtype
  before attending, as the reference does;
* cross-attention (the enc-dec decoder): ``attn_forward(..., kv_x=)`` takes
  K/V from ``kv_x``, and ``attn_decode_cross`` attends to K/V computed
  once at prefill. Where positions are ``None`` no rope is applied, and
  ``causal=False`` (the encoder, the cross-attention) masks nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.kernels.rmsnorm_ops import rmsnorm_op
from repro_torch.models.layers import (apply_rope, draw_normal, param,
                                       state_device)

_NEG_INF = -1e30


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------
class Attention(nn.Module):
    """wq (d, H, hd), wk/wv (d, K, hd), wo (H, hd, d); optional QKV biases
    (zeros) and per-head q/k norm weights (zeros: the '1 + w' scale)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, h, k_, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = cfg.dtype()
        self.cfg = cfg
        self.wq = param((d, h, hd), dt, device)
        self.wk = param((d, k_, hd), dt, device)
        self.wv = param((d, k_, hd), dt, device)
        self.wo = param((h, hd, d), dt, device)
        if cfg.qkv_bias:
            self.bq = param((h, hd), dt, device, fill=0.0)
            self.bk = param((k_, hd), dt, device, fill=0.0)
            self.bv = param((k_, hd), dt, device, fill=0.0)
        if cfg.qk_norm:
            self.q_norm = param((hd,), dt, device, fill=0.0)
            self.k_norm = param((hd,), dt, device, fill=0.0)

    def forward(self, x, positions):
        return attn_forward(self, x, positions, self.cfg)

    def reset_parameters(self, generator: torch.Generator) -> None:
        s = self.cfg.d_model ** -0.5
        draw_normal(self.wq, s, generator)
        draw_normal(self.wk, s, generator)
        draw_normal(self.wv, s, generator)
        draw_normal(self.wo, (self.cfg.n_heads * self.cfg.head_dim) ** -0.5,
                    generator)


# --------------------------------------------------------------------------
# projections
# --------------------------------------------------------------------------
def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one (B·S, d) x (d, H·hd) product."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _project_q(p: Attention, x, positions, cfg):
    q = _proj(x, p.wq)
    if cfg.qkv_bias:
        q = q + p.bq
    if cfg.qk_norm:
        q = rmsnorm_op(q, p.q_norm)
    if positions is None:               # cross-attention queries: no rope
        return q
    return apply_rope(q, positions, cfg.rope_theta)


def _project_kv(p: Attention, x, positions, cfg):
    k = _proj(x, p.wk)
    v = _proj(x, p.wv)
    if cfg.qkv_bias:
        k = k + p.bk
        v = v + p.bv
    if cfg.qk_norm:
        k = rmsnorm_op(k, p.k_norm)
    if positions is None:               # cross-attention keys: no rope
        return k, v
    return apply_rope(k, positions, cfg.rope_theta), v


# --------------------------------------------------------------------------
# core scores → output (GQA grouping, softcap, fp32 softmax)
# --------------------------------------------------------------------------
def _scores_to_probs(scores, mask, hd, cfg, dtype):
    scores = scores.float() * (hd ** -0.5)
    if cfg.attn_softcap:
        scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)
    if mask is not None:
        scores = torch.where(mask, scores, _NEG_INF)
    return torch.softmax(scores, dim=-1).to(dtype)


def _attend(q, k, v, mask, cfg):
    """q: (B,Sq,H,hd); k,v: (B,Skv,K,hd); mask: broadcastable (B,1,Sq,Skv)
    boolean (True = attend) or None."""
    b, sq, h, hd = q.shape
    n_kv = k.shape[2]
    if n_kv != h and sq == 1:
        # decode: the grouped product, without expanding K/V G times
        g = h // n_kv
        qg = q.reshape(b, sq, n_kv, g, hd)
        scores = torch.einsum("bskgh,btkh->bkgst", qg, k)
        probs = _scores_to_probs(scores, None if mask is None else
                                 mask[:, :, None], hd, cfg, q.dtype)
        out = torch.einsum("bkgst,btkh->bskgh", probs, v)
        return out.reshape(b, sq, h, hd)
    if n_kv != h:
        g = h // n_kv
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    scores = torch.einsum("bshk,bthk->bhst", q, k)
    probs = _scores_to_probs(scores, mask, hd, cfg, q.dtype)
    return torch.einsum("bhst,bthk->bshk", probs, v)


def _causal_mask(sq: int, skv: int, offset: int = 0, window: int = 0,
                 device=None) -> torch.Tensor:
    """(1, 1, sq, skv) boolean; query i attends key j iff
    j <= i+offset and (window == 0 or j > i+offset-window)."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(skv, device=device)[None, :]
    m = kj <= qi
    if window:
        m = m & (kj > qi - window)
    return m[None, None]


# --------------------------------------------------------------------------
# train / prefill forward
# --------------------------------------------------------------------------
def attn_forward(p: Attention, x, positions, cfg, *, causal: bool = True,
                 window: int = 0, kv_x=None, kv_positions=None):
    """Attention over the sequence: self-attention when ``kv_x`` is None,
    else cross-attention to ``kv_x`` (at ``kv_positions``); ``causal``
    masks future keys and ``window`` > 0 keeps the last ``window`` keys of
    each query. Chunks queries when S > max(attn_chunk, 2048).
    → (out, (k, v))."""
    q = _project_q(p, x, positions, cfg)
    if kv_x is None:
        k, v = _project_kv(p, x, positions, cfg)
    else:
        k, v = _project_kv(p, kv_x, kv_positions, cfg)
    sq, skv = q.shape[1], k.shape[1]

    chunk = cfg.attn_chunk
    if sq <= max(chunk, 2048):
        mask = (_causal_mask(sq, skv, window=window, device=x.device)
                if causal else None)
        out = _attend(q, k, v, mask, cfg)
    else:
        # a loop over query chunks: the live scores buffer is (chunk, skv)
        if sq % chunk:
            raise ValueError(f"sequence {sq} is not a multiple of "
                             f"attn_chunk {chunk}")
        outs = []
        for ci in range(sq // chunk):
            mask = (_causal_mask(chunk, skv, offset=ci * chunk,
                                 window=window, device=x.device)
                    if causal else None)
            outs.append(_attend(q[:, ci * chunk:(ci + 1) * chunk], k, v,
                                mask, cfg))
        out = torch.cat(outs, dim=1)
    return _out_proj(out, p.wo), (k, v)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one (B·S, H·hd) x (H·hd, d) product."""
    return out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


# --------------------------------------------------------------------------
# caches (optionally int8: per-(b, t, head) symmetric scales, dequantized
# at read)
# --------------------------------------------------------------------------
def _quantize_kv(x: torch.Tensor):
    """x: (B, S, K, hd) → (int8 values, fp32 scales (B, S, K)): the scale
    is max|x| / 127 floored at 1e-8 / 127, the values rounded half to even
    and clipped to ±127."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


@dataclasses.dataclass
class AttnCache:
    """k, v: (B, size, K, hd) in the compute dtype, or int8 with fp32
    scales ``k_scale``/``v_scale`` (B, size, K) under ``kv_quant``; pos:
    (size,) int32, the global position held in each slot (-1 = empty). A
    ring (``local`` blocks) holds position t in slot t % size."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_attn_cache(cfg, batch: int, max_len: int, window: int = 0,
                    device=None) -> AttnCache:
    """window > 0 → a ring of min(window, max_len) slots."""
    dev = state_device(device)
    size = min(window, max_len) if window else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    pos = torch.full((size,), -1, dtype=torch.int32, device=dev)
    if cfg.kv_quant:
        return AttnCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev), pos=pos,
            k_scale=torch.zeros(shape[:3], dtype=torch.float32, device=dev),
            v_scale=torch.zeros(shape[:3], dtype=torch.float32, device=dev))
    dt = cfg.dtype("compute")
    return AttnCache(k=torch.zeros(shape, dtype=dt, device=dev),
                     v=torch.zeros(shape, dtype=dt, device=dev), pos=pos)


def _store(cache: AttnCache, slots, k: torch.Tensor, v: torch.Tensor,
           positions: torch.Tensor) -> None:
    """Write K/V (B, n, K, hd) into ``slots`` (a slice or n indices) of the
    cache in place, quantized when the cache is int8."""
    if cache.quantized:
        k, cache.k_scale[:, slots] = _quantize_kv(k)
        v, cache.v_scale[:, slots] = _quantize_kv(v)
    cache.k[:, slots] = k
    cache.v[:, slots] = v
    cache.pos[slots] = positions


def fill_cache_from_prefill(cache: AttnCache, k: torch.Tensor,
                            v: torch.Tensor, window: int = 0) -> AttnCache:
    """Store prefill K/V in the cache, in place: slots [0, S), or, for a
    ring shorter than the prompt, the last ``size`` positions at
    ``pos % size`` (each slot written once: the reference's write in
    ``argsort`` order leaves the same slot → position map)."""
    s = k.shape[1]
    size = cache.k.shape[1]
    if window and s > size:
        pos = torch.arange(s - size, s, dtype=torch.int32, device=k.device)
        _store(cache, (pos % size).long(), k[:, -size:], v[:, -size:], pos)
        return cache
    if s > size:
        raise ValueError(f"prompt of {s} tokens exceeds the cache's "
                         f"{size} slots")
    _store(cache, slice(0, s), k, v,
           torch.arange(s, dtype=torch.int32, device=k.device))
    return cache


# --------------------------------------------------------------------------
# decode: one token against the cache
# --------------------------------------------------------------------------
def attn_decode(p: Attention, x, cache: AttnCache, pos: int, cfg, *,
                window: int = 0):
    """x: (B, 1, D); pos: host int, the new token's position. Writes its
    K/V into slot ``pos`` (``pos % size`` for a ring) in place.
    → (out (B,1,D), cache)."""
    size = cache.k.shape[1]
    if pos < 0 or (not window and pos >= size):
        raise ValueError(f"position {pos} is outside the cache's "
                         f"{size} slots")
    slot = pos % size if window else pos
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    q = _project_q(p, x, positions, cfg)
    k_new, v_new = _project_kv(p, x, positions, cfg)
    _store(cache, slice(slot, slot + 1), k_new, v_new, pos)
    if cache.quantized:
        k = _dequantize_kv(cache.k, cache.k_scale, x.dtype)
        v = _dequantize_kv(cache.v, cache.v_scale, x.dtype)
    else:
        k, v = cache.k, cache.v
    valid = (cache.pos >= 0) & (cache.pos <= pos)
    if window:
        valid = valid & (cache.pos > pos - window)
    out = _attend(q, k, v, valid[None, None, None, :], cfg)
    return _out_proj(out, p.wo), cache


def attn_decode_cross(p: Attention, x, cross_kv, cfg):
    """Cross-attention decode: x (B, 1, D) against the encoder's K/V
    (B, S_enc, K, hd), computed once at prefill (no rope, no mask)."""
    q = _project_q(p, x, None, cfg)
    k, v = cross_kv
    return _out_proj(_attend(q, k, v, None, cfg), p.wo)
