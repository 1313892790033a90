"""Training step builder: microbatched gradient accumulation, remat, AdamW.

The counterpart of ``repro/runtime/train.py`` on one card:

* the global batch is taken in ``cfg.microbatches`` slices of its leading
  axis, so the live activation set is one microbatch; each slice's
  gradient is added to an accumulator of ``cfg.dtype("opt")`` as
  ``(acc.float() + g.float() / m).to(acc_dt)``, and the loss is the mean
  over the slices. With one slice the gradients are cast to fp32, as there;
* every block is rematerialised as ``cfg.remat`` says
  (``models/transformer.py::forward_train``);
* ``adamw_update`` updates the parameters and moments in place (the
  reference's jitted step donates them). Weight decay acts on the leaves
  the reference decays (:func:`decayed_leaves`).

The step runs where the model lies, which must be the device
``build_train_step_fn`` resolved: the card unless ``device="cpu"``. An
enc-dec config's model is the ``EncDec`` and its batches carry
``"frames"``.
``make_train_step`` with a mesh and sharding rules waits for the LM on a
mesh (ROADMAP.md, item 13.4).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import models
from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.runtime.loss import lm_loss

_AUX_WEIGHT = 0.01     # MoE load-balance loss weight


def _on(v, device: torch.device) -> torch.Tensor:
    """A batch array (tensor or numpy, read-only included) on ``device``."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(v))
    return v.to(device)


def _loss_fn(params, batch: dict, cfg):
    """→ (loss + aux term, loss) over one microbatch; the aux term is the
    MoE layers' load-balance loss. A vision model takes ``batch["patches"]``
    and its loss is on the text positions; an enc-dec model takes
    ``batch["frames"]`` and its loss is on the decoder's positions."""
    hidden, aux = models.forward_train(params, batch["tokens"], cfg,
                                       models.extra_input(cfg, batch))
    loss = lm_loss(params.embed, hidden, batch["targets"], cfg)
    return loss + _AUX_WEIGHT * aux, loss


def decayed_leaves(params, cfg) -> set[str]:
    """The parameters the reference's ``adamw_update`` decays. It skips
    leaves of one dimension, but it sees each scanned layer's parameters
    stacked (n_periods, ...), so only the final norm and the remainder
    layers' 1-D leaves are skipped: the scanned blocks' norm scales and
    biases (and the SSD's and RG-LRU's fp32 vectors) are decayed too
    (ROADMAP.md, queue 3). An enc-dec model's encoder and decoder blocks
    are all stacked, so only its two final norms are skipped. The MoE
    routers (fp32), experts (3-D) and the frontend's projection are
    decayed, as there."""
    scanned = cfg.n_layers - cfg.n_layers % len(cfg.pattern)
    out = set()
    for name, p in params.named_parameters():
        parts = name.split(".")
        if (p.ndim > 1 or parts[0] in ("enc_blocks", "dec_blocks")
                or (parts[0] == "blocks" and int(parts[1]) < scanned)):
            out.add(name)
    return out


def build_train_step_fn(cfg, opt: AdamWConfig, rules=None,
                        device: DeviceLike = None):
    """Returns ``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``: ``params`` the ``Transformer`` (an enc-dec config's
    ``EncDec``), ``batch`` a dict of ``"tokens"`` and ``"targets"`` (B, S)
    integers (and ``"patches"`` (B, n_patches, frontend_dim) for a vision
    model, ``"frames"`` (B, S_enc, frontend_dim) for an enc-dec one),
    metrics ``loss``,
    ``lr`` and ``grad_norm`` (0-d fp32 tensors on the device)."""
    if rules is not None:
        raise NotImplementedError(
            "sharding rules wait for the LM on a mesh (ROADMAP.md, item "
            "13.4); rules=None is the only value taken")
    dev = resolve_device(device)

    def train_step(params, opt_state: dict, batch: dict):
        where = params.embed.table.device
        if where.type != dev.type:
            raise ValueError(f"the model lies on {where}, the step was "
                             f"built for {dev}")
        batch = {k: _on(v, where) for k, v in batch.items()}
        names, leaves = zip(*params.named_parameters())
        m = cfg.microbatches
        acc_dt = cfg.dtype("opt")
        if m == 1:
            total, loss = _loss_fn(params, batch, cfg)
            grads = [g.float() for g in torch.autograd.grad(total, leaves)]
        else:
            b = next(iter(batch.values())).shape[0]
            if b % m:
                raise ValueError(f"batch {b} does not split into {m} "
                                 f"microbatches")
            grads = [torch.zeros(p.shape, dtype=acc_dt, device=where)
                     for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=where)
            for i in range(m):
                mb = {k: v.reshape(m, b // m, *v.shape[1:])[i]
                      for k, v in batch.items()}
                total, mb_loss = _loss_fn(params, mb, cfg)
                g = torch.autograd.grad(total, leaves)
                with torch.no_grad():
                    for acc, gi in zip(grads, g):
                        acc.copy_((acc.float() + gi.float() / m).to(acc_dt))
                    loss = loss + mb_loss.detach() / m
                del g, total, mb_loss
        params, opt_state, metrics = adamw_update(
            dict(zip(names, grads)), opt_state, params, opt,
            decayed_leaves(params, cfg))
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def make_train_step(cfg, opt: AdamWConfig, mesh, rules, params_tree=None,
                    opt_tree=None, batch_tree=None, opt_rules=None):
    """The reference's jitted, sharded step: waits for the LM on a mesh."""
    raise NotImplementedError(
        "make_train_step with a mesh waits for the LM on a mesh "
        "(ROADMAP.md, item 13.4); on one card use build_train_step_fn")


def init_train_state(key, cfg, opt_dtype=None, device: DeviceLike = None):
    """``(model, opt_state)``: the weights drawn from ``key`` (an int seed,
    or a ``torch.Generator`` on the device), zero moments of ``opt_dtype``
    (default ``cfg.dtype("opt")``)."""
    dev = resolve_device(device)
    if not isinstance(key, torch.Generator):
        key = torch.Generator(device=dev).manual_seed(int(key))
    model = models.init_model(cfg, key, dev)
    return model, init_opt_state(model, opt_dtype or cfg.dtype("opt"))


def abstract_train_state(cfg):
    """``(model, opt_state)`` on the ``meta`` device: shapes and dtypes, no
    memory."""
    model = models.build_model(cfg, "meta")
    return model, init_opt_state(model, cfg.dtype("opt"))
