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

On a mesh (``rules``, ``make_train_step``) every rank runs the same step
(SPMD) and holds each parameter, moment and accumulator as the block its
spec names: the model's parameters are ``DTensor``s placed by
``param_specs(rules)`` (``sharding.rules.place_module``: each rank keeps its
block of weights every rank drew from the same seed, no scatter from a
root), the moments by ``param_specs(opt_rules or rules)`` (ZeRO-1 with
``opt_rules``: parameters replicated over the DP axes, moments sharded).
Each rank takes its rows of each microbatch by ``batch_spec`` (microbatch
i is the global batch's rows ``[i·B/m, (i+1)·B/m)``, as there), gathers a
block's weights when the block runs (``sharding.ctx``), and gets the
gradient of its own blocks, summed over the batch axes in rank order. The
global gradient norm counts each leaf once: each rank's sum of squares is
summed over the axes that shard the leaf, never over those it is
replicated on. The update runs on the rank's blocks in place; under ZeRO-1
on the moments' blocks, after which each parameter is gathered whole over
the DP axes (one gather a step). On a mesh whose axes all have one rank the
step is the single-process step, bitwise: no collective is issued.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import models
from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.runtime.loss import lm_loss
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.sharding.rules import (ShardingRules, batch_spec,
                                        param_specs, place_module,
                                        shard_tensor, spec_axes, spec_dims)

_AUX_WEIGHT = 0.01     # MoE load-balance loss weight


def _on(v, device: torch.device) -> torch.Tensor:
    """A batch array (tensor or numpy, read-only included) on ``device``."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(v))
    return v.to(device)


def _loss_fn(params, batch: dict, cfg, rules=None):
    """→ (loss + aux term, loss) over one microbatch; the aux term is the
    MoE layers' load-balance loss. A vision model takes ``batch["patches"]``
    and its loss is on the text positions; an enc-dec model takes
    ``batch["frames"]`` and its loss is on the decoder's positions. In a
    sharded step both are the rank's share: the ranks of the batch axes
    sum to the whole."""
    hidden, aux = models.forward_train(params, batch["tokens"], cfg,
                                       models.extra_input(cfg, batch))
    loss = lm_loss(params.embed, hidden, batch["targets"], cfg, rules)
    ranks = shard_ctx.batch_ranks()
    if ranks > 1:                   # every batch rank holds the global aux
        aux = aux / ranks
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


def _accumulate(params, batch: dict, leaves, cfg, rules=None,
                mine=lambda v: v):
    """``(grads, loss)`` of ``leaves`` over the batch taken in
    ``cfg.microbatches`` slices of its leading axis: each slice's gradient
    added to an accumulator of ``cfg.dtype("opt")`` as ``(acc.float() +
    g.float() / m).to(acc_dt)`` and the loss the slices' mean; with one
    slice the gradients cast to fp32. ``mine`` takes a rank's rows of a
    slice (a sharded step)."""
    m = cfg.microbatches
    acc_dt = cfg.dtype("opt")
    if m == 1:
        total, loss = _loss_fn(params, {k: mine(v) for k, v in
                                        batch.items()}, cfg, rules)
        return ([g.float() for g in torch.autograd.grad(total, leaves)],
                loss.detach())
    b = next(iter(batch.values())).shape[0]
    if b % m:
        raise ValueError(f"batch {b} does not split into {m} microbatches")
    where = leaves[0].device
    grads = [torch.zeros(p.shape, dtype=acc_dt, device=where)
             for p in leaves]
    loss = torch.zeros((), dtype=torch.float32, device=where)
    for i in range(m):
        mb = {k: mine(v.reshape(m, b // m, *v.shape[1:])[i])
              for k, v in batch.items()}
        total, mb_loss = _loss_fn(params, mb, cfg, rules)
        g = torch.autograd.grad(total, leaves)
        with torch.no_grad():
            for acc, gi in zip(grads, g):
                acc.copy_((acc.float() + gi.float() / m).to(acc_dt))
            loss = loss + mb_loss.detach() / m
        del g, total, mb_loss
    return grads, loss


def build_train_step_fn(cfg, opt: AdamWConfig, rules=None,
                        device: DeviceLike = None, opt_rules=None):
    """Returns ``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``: ``params`` the ``Transformer`` (an enc-dec config's
    ``EncDec``), ``batch`` a dict of ``"tokens"`` and ``"targets"`` (B, S)
    integers (and ``"patches"`` (B, n_patches, frontend_dim) for a vision
    model, ``"frames"`` (B, S_enc, frontend_dim) for an enc-dec one),
    metrics ``loss``,
    ``lr`` and ``grad_norm`` (0-d fp32 tensors on the device). With
    ``rules`` the step of every rank of ``rules.mesh`` (the module's
    docstring), its device the mesh's; ``device`` is then not taken."""
    if rules is not None:
        if device is not None:
            raise ValueError("a sharded step runs on its mesh's device: "
                             "pass no device")
        return _sharded_step_fn(cfg, opt, rules, opt_rules)
    if opt_rules is not None:
        raise ValueError("opt_rules need rules")
    dev = resolve_device(device)

    def train_step(params, opt_state: dict, batch: dict):
        where = params.embed.table.device
        if where.type != dev.type:
            raise ValueError(f"the model lies on {where}, the step was "
                             f"built for {dev}")
        batch = {k: _on(v, where) for k, v in batch.items()}
        names, leaves = zip(*params.named_parameters())
        grads, loss = _accumulate(params, batch, leaves, cfg)
        params, opt_state, metrics = adamw_update(
            dict(zip(names, grads)), opt_state, params, opt,
            decayed_leaves(params, cfg))
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def make_train_step(cfg, opt: AdamWConfig, mesh, rules: ShardingRules,
                    params_tree=None, opt_tree=None, batch_tree=None,
                    opt_rules=None):
    """The sharded step on ``mesh``: ``train_step(params, opt_state, batch)
    → (params, opt_state, metrics)``. As the reference's ``in_shardings``,
    it places the parameters and moments it is given by the rules when they
    are not placed yet (each rank keeping its block of tensors every rank
    holds), and refuses ones placed otherwise. The ``*_tree`` arguments
    (the reference's shapes for its jit) are not needed here."""
    if rules.mesh is not mesh:
        raise ValueError("the rules were made for another mesh")
    return build_train_step_fn(cfg, opt, rules, opt_rules=opt_rules)


def place_train_state(cfg, params, opt_state: dict, rules: ShardingRules,
                      opt_rules=None):
    """``(params, opt_state)`` placed in place by the rules (the moments by
    ``opt_rules`` when given); already placed leaves are kept."""
    mesh = rules.mesh
    place_module(params, mesh, param_specs(cfg, params, rules))
    o_specs = param_specs(cfg, params, opt_rules or rules)
    for key in ("m", "v"):
        opt_state[key] = {k: shard_tensor(t, mesh, o_specs[k])
                          for k, t in opt_state[key].items()}
    return params, opt_state


def _group_norm(grads: dict, dims: dict, mesh) -> torch.Tensor:
    """The global norm of sharded gradients: the fp32 sums of squares of
    the leaves split over the same axes are added, summed over those axes
    in rank order, then added over the groups (a leaf replicated on an
    axis is not summed over it, so it counts once)."""
    groups = {}
    for name, g in grads.items():
        axes = tuple(a for ax in dims[name].values()
                     for a in mesh_mod.active_axes(mesh, ax))
        groups.setdefault(axes, []).append(torch.sum(torch.square(
            g.float())))
    sums = []
    for axes, parts in groups.items():
        total = torch.sum(torch.stack(parts))
        sums.append(mesh_mod.psum(total, mesh, axes) if axes else total)
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _sharded_step_fn(cfg, opt: AdamWConfig, rules: ShardingRules,
                     opt_rules=None):
    mesh = rules.mesh
    dev = torch.device(mesh.device_type)
    last = {}

    def key(params, opt_state: dict) -> tuple:
        return (id(params), *(id(p) for p in params.parameters()),
                *(id(t) for k in ("m", "v") for t in opt_state[k].values()))

    def plan(params, opt_state: dict) -> dict:
        """The state placed, and for each leaf its dims, its local block and
        that block as a leaf for autograd (sharing its storage), the
        moments' local blocks, the cut to the moments' block (under ZeRO-1,
        the axes the moments add; ``None`` where it is the whole block) and
        the decay: made once while the model and the state hold the same
        tensors, so a step allocates little of its own."""
        if last.get("key") == key(params, opt_state):
            return last["plan"]
        place_train_state(cfg, params, opt_state, rules, opt_rules)
        p_specs = param_specs(cfg, params, rules)
        o_specs = param_specs(cfg, params, opt_rules or rules)
        placed = dict(params.named_parameters())
        dims = {n: spec_dims(s) for n, s in p_specs.items()}
        with torch.no_grad():
            blocks = {n: t.to_local() for n, t in placed.items()}
            moments = {k: {n: opt_state[k][n].to_local() for n in placed}
                       for k in ("m", "v")}
        cuts = {}
        for n, s in o_specs.items():
            extra = {d: tuple(a for a in ax if a not in dims[n].get(d, ()))
                     for d, ax in spec_dims(s).items()}
            extra = {d: ax for d, ax in extra.items() if ax}
            if any(mesh_mod.active_axes(mesh, ax) for ax in extra.values()):
                cuts[n] = (mesh_mod.block_slices(blocks[n].shape, mesh,
                                                 extra), extra)
        leaves = [blocks[n].detach().requires_grad_(placed[n].requires_grad)
                  for n in placed]
        last["plan"] = {
            "names": list(placed), "dims": dims, "blocks": blocks,
            "moments": moments, "cuts": cuts, "leaves": leaves,
            "registry": {id(placed[n]): (leaf, dims[n])
                         for n, leaf in zip(placed, leaves)},
            "decayed": decayed_leaves(params, cfg)}
        last["key"] = key(params, opt_state)
        return last["plan"]

    def train_step(params, opt_state: dict, batch: dict):
        p = plan(params, opt_state)
        names, blocks, cuts = p["names"], p["blocks"], p["cuts"]
        where = params.embed.table.device
        if where.type != dev.type:
            raise ValueError(f"the model lies on {where}, the mesh on "
                             f"{dev.type}")
        batch = {k: _on(v, where) for k, v in batch.items()}
        m = cfg.microbatches
        b = next(iter(batch.values())).shape[0]
        rows = {0: spec_axes(batch_spec(rules, b // m)[0])}
        shards = shard_ctx.Shards(
            mesh, p["registry"],
            batch_axes=mesh_mod.active_axes(mesh, rows[0]), tp=rules.tp)
        with shard_ctx.use_rules(rules), shard_ctx.use_shards(shards):
            grads, loss = _accumulate(
                params, batch, p["leaves"], cfg, rules,
                lambda v: mesh_mod.local_of(v, mesh, rows))
        grads = dict(zip(names, grads))
        loss = mesh_mod.psum(loss, mesh, mesh_mod.active_axes(mesh, rows[0]))
        gnorm = _group_norm(grads, p["dims"], mesh)
        # the update on the moments' blocks: under ZeRO-1 a view of each
        # parameter's block, which is then gathered whole
        with torch.no_grad():
            if cuts:
                grads = {n: g[cuts[n][0]] if n in cuts else g
                         for n, g in grads.items()}
                update = {n: blocks[n][cuts[n][0]] if n in cuts else
                          blocks[n] for n in names}
            else:
                update = blocks
            local_opt = {**p["moments"], "step": opt_state["step"]}
            _, local_opt, metrics = adamw_update(
                grads, local_opt, update, opt, p["decayed"], gnorm=gnorm)
            opt_state["step"] = local_opt["step"]
            for n, (cut, extra) in cuts.items():
                blocks[n].copy_(mesh_mod.gather_dims(
                    blocks[n][cut].contiguous(), mesh, extra))
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


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
