"""AdamW with warmup + cosine schedule and global-norm clipping.

The counterpart of ``repro/optim/adamw.py``, with the same config, schedule
and update arithmetic, all in fp32. The moment dtype is the caller's
(``cfg.dtype("opt")``): fp32 by default.

Parameters, gradients and moments are flat mappings from a parameter's
name (its ``state_dict`` key) to its tensor; a ``torch.nn.Module`` may
stand for its parameters. Where the reference returns new trees, the port
updates the parameters and moments in place, one tensor at a time under
``torch.no_grad()``, so the fp32 temporaries never exceed a few copies of
one leaf (ROADMAP.md, queue 3). ``opt_state`` is ``{"m": {name: tensor},
"v": {name: tensor}, "step": int32 0-d tensor}``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Set, Union

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def named_leaves(params: Params) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` of a module's parameters, or the mapping itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def lr_schedule(opt: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), fp32: linear
    warmup to ``peak_lr``, then a cosine to ``min_lr_ratio·peak_lr``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = opt.peak_lr * step / max(opt.warmup_steps, 1)
    prog = torch.clamp((step - opt.warmup_steps)
                       / max(opt.decay_steps - opt.warmup_steps, 1), 0.0, 1.0)
    cos = opt.min_lr_ratio + (1 - opt.min_lr_ratio) * 0.5 \
        * (1 + torch.cos(math.pi * prog))
    return torch.where(step < opt.warmup_steps, warm, opt.peak_lr * cos)


def init_opt_state(params: Params, dtype=torch.float32) -> dict:
    """Zero moments of ``dtype`` beside each parameter, and step 0."""
    leaves = named_leaves(params)
    device = next(iter(leaves.values())).device if leaves else None
    zeros = {k: torch.zeros(p.shape, dtype=dtype, device=p.device)
             for k, p in leaves.items()}
    return {"m": zeros,
            "v": {k: torch.zeros_like(z) for k, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum, over the tensors, of each one's fp32 sum of squares."""
    sums = [torch.sum(torch.square(t.float())) for t in tensors]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], opt_state: dict,
                 params: Params, opt: AdamWConfig,
                 decayed: Optional[Set[str]] = None,
                 gnorm: Optional[torch.Tensor] = None):
    """→ (params, opt_state, metrics), the parameters and moments updated
    in place. The gradients are clipped to ``clip_norm`` by their global
    norm (``metrics["grad_norm"]`` is the raw norm). Decoupled weight decay
    acts on the leaves named in ``decayed``, by default those of more than
    one dimension (the reference skips 1-D leaves: norm scales, biases).
    ``gnorm`` is the global norm when the caller computed it (a sharded
    step, whose leaves are the rank's blocks).
    ``grads`` may be consumed: an fp32 gradient is scaled in place."""
    leaves = named_leaves(params)
    if set(grads) != set(leaves):
        raise KeyError("grads and params name different leaves: "
                       f"{sorted(set(grads) ^ set(leaves))}")
    if decayed is None:
        decayed = {k for k, p in leaves.items() if p.ndim > 1}
    step = opt_state["step"] + 1
    lr = lr_schedule(opt, step)
    if gnorm is None:
        gnorm = global_norm(grads[k] for k in leaves)
    scale = torch.clamp(opt.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = opt.b1, opt.b2
    c1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    c2 = 1.0 - torch.pow(b2, step.to(torch.float32))
    for name, p in leaves.items():
        m, v = opt_state["m"][name], opt_state["v"][name]
        gf = grads[name].float().mul_(scale) if grads[name].dtype != \
            torch.float32 else grads[name].mul_(scale)
        mf = m.float().mul_(b1).add_((1 - b1) * gf)
        vf = v.float().mul_(b2).add_((1 - b2) * gf * gf)
        del gf
        u = (mf / c1).div_(torch.sqrt(vf / c2).add_(opt.eps))
        if name in decayed:
            u.add_(opt.weight_decay * p.float())
        if p.dtype == torch.float32:
            p.sub_(lr * u)
        else:
            p.copy_(p.float().sub_(lr * u))
        for state, new in ((m, mf), (v, vf)):
            if state.dtype != torch.float32:
                state.copy_(new)
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
