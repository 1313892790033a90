"""RG-LRU recurrent block (Griffin / recurrentgemma).

The counterpart of ``repro/models/rglru.py``. Block structure (Griffin
Fig. 2): input → two linear branches — (a) GeLU gate branch, (b) temporal
conv (width 4) → RG-LRU — multiplied together → output projection.

RG-LRU (fp32 recurrence):
    r_t = σ(W_a u_t + b_a)                 recurrence gate
    i_t = σ(W_x u_t + b_x)                 input gate
    log a_t = -c · softplus(Λ) · r_t       (c = 8)
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ u_t)

Train/prefill runs the linear recurrence ``h_t = a_t h_{t-1} + b_t`` as a
log-depth scan over time: Hillis–Steele doubling over the reference's
combine ``(a_l·a_r, a_r·b_l + b_r)``, 9 steps for a chunk of 512. The
reference's ``lax.associative_scan`` sums in an odd/even tree instead; the
two agree to fp32's rounding, not bitwise (ROADMAP.md, queue 3). As there,
a sequence longer than 512 whose length 512 divides is taken in chunks of
512, the carried (B, R) state folded into each chunk's first offset. Decode
is one step.

``causal_conv`` is the reference's unrolled sum of ``width`` products in the
compute dtype, each product and each partial sum rounded there, not
``F.conv1d`` (which sums in fp32). The gates multiply in fp32 with the
weights upcast (TF32 stays off: ``repro_torch/__init__.py``), and
softplus is ``logaddexp(x, 0)``, JAX's form.

Deviation kept from the reference: the gate weights W_a/W_x are dense
d_rnn×d_rnn (upstream recurrentgemma uses block-diagonal ones).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import draw_normal, param, state_device

_C = 8.0
_CHUNK = 512   # the scan's chunk: bounds the doubling steps' saved tensors


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` as JAX computes it (``logaddexp(x, 0)``), with no
    threshold past which x is returned as it is."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


class Rec(nn.Module):
    """w_gate_branch, w_rec_branch (d, r); conv_w (width, r); w_a, w_x
    (r, r); b_a, b_x (r,) zeros; ``lambda`` (r,) fp32 whatever the param
    dtype; w_out (r, d). ``lambda`` is a Python keyword: read it with
    ``getattr(p, "lambda")``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, r, w = cfg.d_model, cfg.lru_width_actual, cfg.conv_width
        dt = cfg.dtype()
        self.w_gate_branch = param((d, r), dt, device)
        self.w_rec_branch = param((d, r), dt, device)
        self.conv_w = param((w, r), dt, device)
        self.w_a = param((r, r), dt, device)
        self.b_a = param((r,), dt, device, fill=0.0)
        self.w_x = param((r, r), dt, device)
        self.b_x = param((r,), dt, device, fill=0.0)
        self.register_parameter("lambda", param((r,), torch.float32, device))
        self.w_out = param((r, d), dt, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, r = self.w_gate_branch.shape
        draw_normal(self.w_gate_branch, d ** -0.5, generator)
        draw_normal(self.w_rec_branch, d ** -0.5, generator)
        draw_normal(self.conv_w, self.conv_w.shape[0] ** -0.5, generator)
        draw_normal(self.w_a, r ** -0.5, generator)
        draw_normal(self.w_x, r ** -0.5, generator)
        lam = getattr(self, "lambda")
        with torch.no_grad():
            # Λ so that a ∈ [0.9, 0.999] at r = 1 (Griffin appendix):
            # softplus⁻¹(−log u / c), u uniform in [0.9, 0.999]
            u = 0.9 + 0.099 * torch.rand(lam.shape, dtype=torch.float32,
                                         device=lam.device,
                                         generator=generator)
            lam.copy_(torch.log(torch.expm1(-torch.log(u) / _C)))
        draw_normal(self.w_out, r ** -0.5, generator)


def causal_conv(u: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv over time. u: (B,S,R); w: (W,R).
    state: (B, W-1, R) prior context (decode / continuation) or None.
    Returns (out (B,S,R), new_state (B, W-1, R)), the state a tensor of its
    own (not a view of the extended input)."""
    width = w.shape[0]
    if state is None:
        state = torch.zeros((u.shape[0], width - 1, u.shape[2]),
                            dtype=u.dtype, device=u.device)
    ext = torch.cat([state, u], dim=1)                 # (B, S+W-1, R)
    s = u.shape[1]
    out = ext[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + ext[:, i:i + s] * w[i]
    new_state = ext[:, -(width - 1):].clone() if width > 1 else state
    return out, new_state


def _rglru_coeffs(p: Rec, u: torch.Tensor):
    """a_t, b_t of the linear recurrence h_t = a_t h + b_t (fp32)."""
    uf = u.float()
    r_gate = torch.sigmoid(uf @ p.w_a.float() + p.b_a.float())
    i_gate = torch.sigmoid(uf @ p.w_x.float() + p.b_x.float())
    log_a = -_C * softplus(getattr(p, "lambda")) * r_gate
    a = torch.exp(log_a)
    # √(1−a²) computed stably: 1−a² = -expm1(2 log a)
    b = torch.sqrt(-torch.expm1(2.0 * log_a)) * (i_gate * uf)
    return a, b


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h of ``h_t = a_t h_{t-1} + b_t`` from h_{-1} = 0 over axis 1 of
    (B, q, R): Hillis–Steele doubling, ⌈log₂ q⌉ steps. After the step of
    offset d, position t holds the combine of positions (t - 2d, t]."""
    q, d = a.shape[1], 1
    while d < q:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < q:
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def _fold(a: torch.Tensor, b: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """b with ``a[:, 0] · h`` added to its first step."""
    return torch.cat([b[:, :1] + a[:, :1] * h[:, None], b[:, 1:]], dim=1)


def rglru_scan(p: Rec, u: torch.Tensor, cfg, h0=None):
    """u: (B,S,R) → (h (B,S,R) in u's dtype, h_last (B,R) fp32).

    One scan when S <= 512 or 512 does not divide S; else chunks of 512,
    the state carried from chunk to chunk (folded into each chunk's first
    offset), as the reference's ``lax.scan`` over chunks."""
    bsz, s, r = u.shape
    a, b = _rglru_coeffs(p, u)
    if h0 is not None:
        # fold the carried state into the first step's offset
        b = _fold(a, b, h0.float())

    q = _CHUNK if (s % _CHUNK == 0 and s > _CHUNK) else s
    if q == s:
        h = _scan(a, b)
        return h.to(u.dtype), h[:, -1]

    carry = torch.zeros((bsz, r), dtype=torch.float32, device=u.device)
    hs = []
    for c in range(s // q):
        ai, bi = a[:, c * q:(c + 1) * q], b[:, c * q:(c + 1) * q]
        hi = _scan(ai, _fold(ai, bi, carry))
        carry = hi[:, -1]
        hs.append(hi)
    return torch.cat(hs, dim=1).to(u.dtype), carry


def rglru_step(p: Rec, u: torch.Tensor, h: torch.Tensor, cfg):
    """One decode step. u: (B,1,R); h: (B,R) fp32 carried state."""
    a, b = _rglru_coeffs(p, u)
    h_new = a[:, 0] * h + b[:, 0]
    return h_new.to(u.dtype)[:, None], h_new


# --------------------------------------------------------------------------
# full recurrent block
# --------------------------------------------------------------------------
def _branches(p: Rec, x: torch.Tensor):
    gate = F.gelu(x @ p.w_gate_branch, approximate="tanh")
    return gate, x @ p.w_rec_branch


def rec_forward(p: Rec, x, cfg, conv_state=None, h0=None):
    """Train/prefill. x: (B,S,D) → (out, (conv_state, h_last))."""
    gate, u = _branches(p, x)
    u, conv_state = causal_conv(u, p.conv_w, conv_state)
    h, h_last = rglru_scan(p, u, cfg, h0)
    return (gate * h) @ p.w_out, (conv_state, h_last)


@dataclasses.dataclass
class RecCache:
    """conv: (B, width-1, R) in the compute dtype, the conv's last inputs;
    h: (B, R) fp32, the recurrence's state."""
    conv: torch.Tensor
    h: torch.Tensor


def init_rec_cache(cfg, batch: int, device=None) -> RecCache:
    dev = state_device(device)
    r = cfg.lru_width_actual
    return RecCache(
        conv=torch.zeros((batch, cfg.conv_width - 1, r),
                         dtype=cfg.dtype("compute"), device=dev),
        h=torch.zeros((batch, r), dtype=torch.float32, device=dev))


def rec_decode(p: Rec, x, cache: RecCache, cfg):
    """One decode step. x: (B,1,D) → (out, cache), the cache's conv and
    state updated in place."""
    gate, u = _branches(p, x)
    u, conv_state = causal_conv(u, p.conv_w, cache.conv)
    h_seq, h = rglru_step(p, u, cache.h, cfg)
    cache.conv.copy_(conv_state)
    cache.h.copy_(h)
    return (gate * h_seq) @ p.w_out, cache
