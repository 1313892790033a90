"""Mamba-2 SSD (state-space duality) mixer — arXiv:2405.21060.

The counterpart of ``repro/models/ssd.py``. Chunked semantics (chunk
length Q, fp32 state):
  dA_t   = Δ_t · A                                   (per head, A < 0)
  cs     = within-chunk cumsum of dA
  intra:  Y_i += Σ_{j≤i}  (C_i·B_j) · e^{cs_i−cs_j} · Δ_j · x_j
  state:  S_c  = Σ_j  e^{cs_Q−cs_j} · Δ_j · B_j ⊗ x_j
  inter:  h_c  = e^{cs_Q} h_{c−1} + S_c;   Y_i += (C_i·h_{c−1}) · e^{cs_i}
  out:    y = RMSNorm(Y ⊙ SiLU(z)) W_out + D ⊙ x

Two differences from the reference's form:

* the intra-chunk decay masks the exponent before the ``exp``
  (``where(causal, cs_i − cs_j, −inf)``). The reference takes
  ``exp(cs_i − cs_j)`` over the whole (Q, Q) square and zeroes the upper
  triangle after; above the diagonal the exponent passes 88.7 at
  mamba2-1.3b's widths and ``exp`` overflows to ``inf``, so its gradient
  there is ``inf · 0`` = NaN. Masked first, the decay is bitwise the
  same and the gradient finite (ROADMAP.md, queue 3);
* the reference's 3-operand einsum over (scores, decay, x) is two explicit
  products: (C·B) times the decay forms the (B, nc, Q, Q, g, h) weights
  once, and a batched product with x contracts them over the chunk. The
  sums run in another order, so the forward agrees with the reference's
  to fp32 rounding, not bitwise.

The gated norm ``rmsnorm(y ⊙ silu(z), norm_w)`` is the port's ``RMSNorm``
function (``rmsnorm_op``): the ``rmsnorm`` kernel on the card, its
gradient reaching ``norm_w`` through ``RMSNormFunction``. ``dt_bias``,
``a_log`` and ``d_skip`` are fp32 whatever the param dtype, as there.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rmsnorm_ops import rmsnorm_op
from repro_torch.models.layers import draw_normal, param, state_device
from repro_torch.models.rglru import causal_conv, softplus


class SSD(nn.Module):
    """w_x, w_z (d, d_inner); w_b, w_c (d, g·N); w_dt (d, nh); dt_bias,
    a_log, d_skip (nh,) fp32; conv_w (width, d_inner + 2 g·N); norm_w
    (d_inner,) zeros (the '1 + w' scale); w_out (d_inner, d)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        gn, nh = cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_nheads
        dt = cfg.dtype()
        self.w_x = param((d, di), dt, device)
        self.w_z = param((d, di), dt, device)
        self.w_b = param((d, gn), dt, device)
        self.w_c = param((d, gn), dt, device)
        self.w_dt = param((d, nh), dt, device)
        self.dt_bias = param((nh,), torch.float32, device)
        self.a_log = param((nh,), torch.float32, device)
        self.d_skip = param((nh,), torch.float32, device, fill=1.0)
        self.conv_w = param((cfg.conv_width, di + 2 * gn), dt, device)
        self.norm_w = param((di,), dt, device, fill=0.0)
        self.w_out = param((di, d), dt, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, di = self.w_x.shape
        for w in (self.w_x, self.w_z, self.w_b, self.w_c, self.w_dt):
            draw_normal(w, d ** -0.5, generator)
        draw_normal(self.conv_w, self.conv_w.shape[0] ** -0.5, generator)
        with torch.no_grad():
            nh = self.dt_bias.shape[0]
            dev = self.dt_bias.device

            def uniform(lo, hi):
                return lo + (hi - lo) * torch.rand(
                    (nh,), dtype=torch.float32, device=dev,
                    generator=generator)
            # Δ bias: softplus(bias) ∈ [1e-3, 1e-1] (mamba2 init)
            self.dt_bias.copy_(torch.log(torch.expm1(uniform(1e-3, 1e-1))))
            self.a_log.copy_(torch.log(uniform(1.0, 16.0)))
        draw_normal(self.w_out, di ** -0.5, generator)


def _conv_split(p: SSD, x, cfg, conv_state=None):
    """Shared projection + causal conv + split into (xh, B, C, z, dt)."""
    di = cfg.d_inner
    g, n, nh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    z = x @ p.w_z
    u = torch.cat([x @ p.w_x, x @ p.w_b, x @ p.w_c], dim=-1)
    u, conv_state = causal_conv(u, p.conv_w, conv_state)
    u = F.silu(u)
    lead = u.shape[:2]
    xh = u[..., :di].reshape(*lead, nh, cfg.ssm_headdim)
    b_ = u[..., di:di + g * n].reshape(*lead, g, n)
    c_ = u[..., di + g * n:].reshape(*lead, g, n)
    dt = softplus((x @ p.w_dt).float() + p.dt_bias)
    return xh, b_, c_, z, dt, conv_state


def _gated_out(p: SSD, y: torch.Tensor, z: torch.Tensor, x: torch.Tensor,
               cfg) -> torch.Tensor:
    """y (B, S, nh, hd) fp32 → RMSNorm(y ⊙ SiLU(z)) W_out, in x's dtype."""
    y = y.reshape(*y.shape[:2], cfg.d_inner).to(x.dtype)
    y = rmsnorm_op(y * F.silu(z), p.norm_w)
    return y @ p.w_out


@dataclasses.dataclass
class SSDCache:
    """conv: (B, width-1, d_inner + 2 g·N) in the compute dtype, the conv's
    last inputs; h: (B, nh, N, hd) fp32, the state."""
    conv: torch.Tensor
    h: torch.Tensor


def ssd_forward(p: SSD, x, cfg, cache=None):
    """Train/prefill. x: (B,S,D) → (out (B,S,D), SSDCache). ``cache`` (an
    ``SSDCache``) continues from a prior state."""
    bsz, s, _ = x.shape
    g, n, nh, hd = (cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads,
                    cfg.ssm_headdim)
    hpg = nh // g
    q = min(cfg.ssm_chunk, s)
    if s % q:
        q = s
    nc = s // q

    conv_state = cache.conv if cache is not None else None
    h0 = cache.h if cache is not None else None
    xh, b_, c_, z, dt, conv_state = _conv_split(p, x, cfg, conv_state)

    a = -torch.exp(p.a_log)                         # (nh,) fp32, negative
    da = dt * a                                     # (B,S,nh)

    # chunk views
    xc = xh.reshape(bsz, nc, q, g, hpg, hd).float()
    bc = b_.reshape(bsz, nc, q, g, n).float()
    cc = c_.reshape(bsz, nc, q, g, n).float()
    dtc = dt.reshape(bsz, nc, q, g, hpg)
    cs = torch.cumsum(da.reshape(bsz, nc, q, g, hpg), dim=2)

    # ---- intra-chunk: the exponent masked before the exp ----
    scores = torch.einsum("bzqgn,bzkgn->bzqkg", cc, bc)     # (B,nc,Q,Q,g)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    seg = cs[:, :, :, None] - cs[:, :, None]                # (B,nc,Q,Q,g,h)
    decay = torch.exp(torch.where(causal[:, :, None, None], seg,
                                  float("-inf")))
    w_intra = scores[..., None] * (decay * dtc[:, :, None])
    # Σ_k w_intra[q, k] x[k]: batched over (b, z, g, h)
    y = torch.matmul(w_intra.permute(0, 1, 4, 5, 2, 3),
                     xc.permute(0, 1, 3, 4, 2, 5))          # (B,nc,g,h,Q,hd)
    y = y.permute(0, 1, 4, 2, 3, 5)                         # (B,nc,Q,g,h,hd)

    # ---- chunk states ----
    w_state = torch.exp(cs[:, :, -1:] - cs) * dtc            # (B,nc,Q,g,h)
    s_c = torch.einsum("bzkgn,bzkghd->bzghnd", bc, w_state[..., None] * xc)

    # ---- inter-chunk recurrence over nc chunks ----
    chunk_decay = torch.exp(cs[:, :, -1])                    # (B,nc,g,h)
    h = (torch.zeros((bsz, g, hpg, n, hd), dtype=torch.float32,
                     device=x.device) if h0 is None
         else h0.reshape(bsz, g, hpg, n, hd).float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, ..., None, None] + s_c[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                    # (B,nc,g,h,N,hd)

    y_inter = torch.einsum("bzqgn,bzghnd->bzqghd", cc, h_prevs) \
        * torch.exp(cs)[..., None]
    y = (y + y_inter).reshape(bsz, s, nh, hd) \
        + p.d_skip[None, None, :, None] * xh.float()
    out = _gated_out(p, y, z, x, cfg)
    return out, SSDCache(conv=conv_state, h=h.reshape(bsz, nh, n, hd))


def init_ssd_cache(cfg, batch: int, device=None) -> SSDCache:
    dev = state_device(device)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return SSDCache(
        conv=torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                         dtype=cfg.dtype("compute"), device=dev),
        h=torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_state,
                       cfg.ssm_headdim), dtype=torch.float32, device=dev))


def ssd_decode(p: SSD, x, cache: SSDCache, cfg):
    """One decode step, an O(1) state update. x: (B,1,D) → (out, cache),
    the cache's conv and state updated in place."""
    hpg = cfg.ssm_nheads // cfg.ssm_ngroups
    xh, b_, c_, z, dt, conv_state = _conv_split(p, x, cfg, cache.conv)

    a = -torch.exp(p.a_log)
    da = (dt * a)[:, 0]                                  # (B,nh)
    xf = xh[:, 0].float()                                # (B,nh,hd)
    # group-level B/C broadcast to head level (head h ↦ group h // hpg)
    bh = torch.repeat_interleave(b_[:, 0].float(), hpg, dim=1)   # (B,nh,N)
    ch = torch.repeat_interleave(c_[:, 0].float(), hpg, dim=1)
    h = cache.h.float() * torch.exp(da)[..., None, None] \
        + dt[:, 0, :, None, None] * bh[..., None] * xf[:, :, None, :]
    y = torch.einsum("bhn,bhnd->bhd", ch, h) + p.d_skip[None, :, None] * xf
    cache.conv.copy_(conv_state)
    cache.h.copy_(h)
    return _gated_out(p, y[:, None], z, x, cfg), cache
