"""Serving step builders: batched prefill and single-token decode.

The counterpart of ``repro/runtime/serve.py``, with the reference's
signatures: ``params`` is the ``Transformer`` (or, for an enc-dec config,
the ``EncDec``), ``batch`` a dict holding ``"tokens"`` (B, S), and each step
returns ``(logits, cache)``. Prefill returns only the last position's
logits; decode updates the cache in place (the reference's jitted decode
donates it) and returns it.

The builders resolve the device once: the card unless ``device="cpu"``,
raising when there is no card. A vision model's prefill takes the patch
embeddings as ``batch["patches"]`` (B, n_patches, frontend_dim); an enc-dec
model's takes the audio frame embeddings as ``batch["frames"]`` (B, S_enc,
frontend_dim). ``repro_torch.models`` hands each step to the config's
family.

With ``rules`` (``make_prefill_step``, ``make_decode_step``) the steps run
on every rank of ``rules.mesh``, on its device: the parameters are placed
by ``param_specs`` (placed on the first call when they are not yet, as the
reference's ``in_shardings``), each rank takes its rows of the batch by
``batch_spec`` and gathers each block's weights when the block runs. The
cache is placed by ``cache_specs``: ``k``/``v`` sequence-sharded over
"model" above 4096 slots, else over their heads when the axis divides
them. A decode step gathers a layer's cache for the rank's rows when the
layer runs, updates it and writes the rank's block back in place
(``sharding.ctx.gathered_cache``). The logits come back as a ``DTensor``
placed by ``batch_spec`` (``launch.mesh.full_tensor`` assembles them). On a
mesh whose axes all have one rank the steps are the unsharded ones,
bitwise, and a step swaps the model's and the cache's blocks in once
(``sharding.ctx.swapped``) rather than a layer at a time. A decode step
holds the last cache it was given.
"""

from __future__ import annotations

import torch

from repro_torch import models
from repro_torch.kernels.dispatch import DeviceLike, resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.layers import lm_logits
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.sharding.rules import (ShardingRules, _cache_spec,
                                        batch_spec, cache_leaves,
                                        cache_specs, from_block, param_specs,
                                        place_module, shard_tensor,
                                        spec_axes, spec_dims)


def _on(params, dev: torch.device, array):
    """The tokens (or patches, or frames) as a tensor on ``dev``; raise unless the
    model lies there."""
    where = params.embed.table.device
    if where.type != dev.type:
        raise ValueError(f"the model lies on {where}, the step was built "
                         f"for {dev}")
    return torch.as_tensor(array, device=where)


def _mesh_device(rules: ShardingRules, device) -> torch.device:
    if device is not None:
        raise ValueError("a sharded step runs on its mesh's device: pass "
                         "no device")
    return torch.device(rules.mesh.device_type)


class _Sharded:
    """A step's view of the mesh: the model placed, its blocks registered,
    the rank's rows of a global batch of ``b``. On a mesh of one rank the
    blocks are the weights and a step swaps them all in at once
    (``weights``), so it does the unsharded step's host work."""

    def __init__(self, cfg, rules: ShardingRules, params, b: int):
        self.mesh, self.rules, self.b = rules.mesh, rules, b
        self.model_id = id(params)
        self.local_only = self.mesh.size() == 1
        specs = param_specs(cfg, params, rules)
        place_module(params, self.mesh, specs)
        self.rows = {0: spec_axes(batch_spec(rules, b)[0])}
        # each block a leaf that requires grad as its parameter does: the
        # products take the paths they take on the parameter itself
        with torch.no_grad():
            leaves = {id(p): (p.to_local().detach().requires_grad_(
                          p.requires_grad), spec_dims(specs[n]))
                      for n, p in params.named_parameters()}
        self.shards = shard_ctx.Shards(
            self.mesh, leaves,
            batch_axes=mesh_mod.active_axes(self.mesh, self.rows[0]),
            tp=rules.tp)
        self.swaps = [(m._parameters, attr, p, leaves[id(p)][0])
                      for m in params.modules()
                      for attr, p in m._parameters.items() if p is not None]

    def holds(self, params, b: int) -> bool:
        """Whether ``params`` is the model placed here, its parameters the
        ones placed, and ``b`` the batch."""
        return (self.model_id == id(params) and self.b == b
                and shard_ctx.holds(self.swaps))

    def weights(self):
        """The context of a step's weights: every block swapped in at once
        on a mesh of one rank, else each block's gathered when it runs."""
        if self.local_only:
            return shard_ctx.swapped(self.swaps)
        return shard_ctx.use_shards(self.shards)

    def mine(self, t: torch.Tensor) -> torch.Tensor:
        if self.local_only:
            return t
        return mesh_mod.local_of(t, self.mesh, self.rows)

    def logits(self, local: torch.Tensor, b: int):
        """The rank's rows of the logits as a DTensor placed by
        ``batch_spec``."""
        return from_block(local, self.mesh, batch_spec(self.rules, b, 3),
                          (b, *local.shape[1:]))

    def place_cache(self, cfg, cache, b: int):
        """Each tensor of a cache of the rank's rows placed by
        ``cache_specs`` (of the global batch ``b``), in place."""
        for name, obj, f in cache_leaves(cache):
            t = getattr(obj, f)
            shape = (b, *t.shape[1:]) if name.rsplit(".", 1)[-1] != "pos" \
                else tuple(t.shape)
            spec = _cache_spec(name, shape, cfg, self.rules)
            dims = {d: ax for d, ax in spec_dims(spec).items() if d}
            local = t
            if any(mesh_mod.active_axes(self.mesh, ax)
                   for ax in dims.values()):
                local = mesh_mod.local_of(t, self.mesh, dims).clone()
            setattr(obj, f, from_block(local, self.mesh, spec, shape))
        return cache


def _memo(cfg, rules: ShardingRules):
    """``sharded(params, b)``: the ``_Sharded`` of the last call while the
    model holds the same parameter objects and the batch is as large (a
    step's placement and registration are made once, not each step)."""
    last = {}

    def sharded(params, b: int) -> _Sharded:
        if "value" not in last or not last["value"].holds(params, b):
            last["value"] = _Sharded(cfg, rules, params, b)
        return last["value"]
    return sharded


def build_prefill_fn(cfg, max_len: int, rules=None,
                     device: DeviceLike = None):
    if rules is not None:
        return _sharded_prefill(cfg, max_len, rules,
                                _mesh_device(rules, device))
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch):
        extra = models.extra_input(cfg, batch)
        hidden, cache = models.prefill(
            params, _on(params, dev, batch["tokens"]), cfg,
            None if extra is None else _on(params, dev, extra),
            max_len=max_len)
        # only the last position's logits are needed to start decoding
        return lm_logits(params.embed, hidden[:, -1:], cfg), cache

    return prefill_step


def build_decode_fn(cfg, rules=None, device: DeviceLike = None):
    if rules is not None:
        return _sharded_decode(cfg, rules, _mesh_device(rules, device))
    dev = resolve_device(device)

    @torch.no_grad()
    def decode_step(params, token, cache):
        hidden, cache = models.decode_step(params, _on(params, dev, token),
                                           cache, cfg)
        return lm_logits(params.embed, hidden, cfg), cache

    return decode_step


def _sharded_prefill(cfg, max_len: int, rules: ShardingRules,
                     dev: torch.device):
    sharded = _memo(cfg, rules)

    @torch.no_grad()
    def prefill_step(params, batch):
        tokens = _on(params, dev, batch["tokens"])
        b = tokens.shape[0]
        sh = sharded(params, b)
        extra = models.extra_input(cfg, batch)
        if extra is not None:
            extra = sh.mine(_on(params, dev, extra))
        with shard_ctx.use_rules(rules), sh.weights():
            hidden, cache = models.prefill(params, sh.mine(tokens), cfg,
                                           extra, max_len=max_len)
            logits = lm_logits(params.embed, hidden[:, -1:], cfg)
        return sh.logits(logits, b), sh.place_cache(cfg, cache, b)

    return prefill_step


def _sharded_decode(cfg, rules: ShardingRules, dev: torch.device):
    sharded = _memo(cfg, rules)
    placed = {}     # the last cache (held), its rows and its tensors

    @torch.no_grad()
    def decode_step(params, token, cache):
        token = _on(params, dev, token)
        b = token.shape[0]
        sh = sharded(params, b)
        if placed.get("cache") is not cache or \
                not shard_ctx.holds(placed["swaps"]):   # placed once a cache
            place_cache(cfg, cache, rules)
            placed.update(cache=cache, rows=_cache_batch(cache),
                          swaps=_cache_swaps(cache))
        if placed["rows"] != b:
            raise ValueError(f"{b} tokens for a cache of {placed['rows']} "
                             f"rows")
        # one rank: the cache's blocks swapped in at once, not a layer at
        # a time by ``gathered_cache``
        whole = shard_ctx.swapped(placed["swaps"] if sh.local_only else ())
        with shard_ctx.use_rules(rules), sh.weights(), whole:
            hidden, cache = models.decode_step(params, sh.mine(token), cache,
                                               cfg)
            logits = lm_logits(params.embed, hidden, cfg)
        return sh.logits(logits, b), cache

    return decode_step


def _cache_swaps(cache) -> list:
    """``shard_ctx.swapped``'s entries for a placed cache: each tensor's
    holder (``vars``), field, ``DTensor`` and local block."""
    return [(vars(obj), f, t, t.to_local())
            for _, obj, f in cache_leaves(cache)
            for t in (getattr(obj, f),)]


def place_cache(cfg, cache, rules: ShardingRules):
    """A cache of global tensors every rank holds placed by
    ``cache_specs``, in place (its tensors already placed so are kept)."""
    specs = cache_specs(cfg, cache, rules)
    for name, obj, f in cache_leaves(cache):
        setattr(obj, f, shard_tensor(getattr(obj, f), rules.mesh,
                                     specs[name]))
    return cache


def abstract_cache(cfg, batch: int, max_len: int, enc_len: int = 0):
    """The cache of ``batch`` rows and ``max_len`` slots on the ``meta``
    device: shapes and dtypes, no memory."""
    if cfg.is_encdec:
        from repro_torch.models.encdec import init_cache_encdec
        return init_cache_encdec(cfg, batch, max_len, enc_len, "meta")
    from repro_torch.models.transformer import init_cache
    return init_cache(cfg, batch, max_len, "meta")


def make_prefill_step(cfg, mesh, rules: ShardingRules, params_tree,
                      batch_tree, max_len: int):
    """The sharded prefill on ``mesh``: ``prefill_step(params, batch) →
    (logits, cache)``, the cache placed by ``cache_specs``. The ``*_tree``
    arguments (the reference's shapes for its jit) are not needed here."""
    if rules.mesh is not mesh:
        raise ValueError("the rules were made for another mesh")
    return build_prefill_fn(cfg, max_len, rules)


def make_decode_step(cfg, mesh, rules: ShardingRules, params_tree,
                     cache_tree):
    """The sharded decode on ``mesh``: ``decode_step(params, token, cache)
    → (logits, cache)``, the cache (placed by ``cache_specs`` on the first
    call when it is not yet) updated in place. The ``*_tree`` arguments are
    not needed here."""
    if rules.mesh is not mesh:
        raise ValueError("the rules were made for another mesh")
    return build_decode_fn(cfg, rules)


def _cache_batch(cache_tree) -> int:
    """The batch of a cache: the leading dim of its first tensor of two or
    more dims (the port's caches are one a layer, unstacked)."""
    for name, obj, f in cache_leaves(cache_tree):
        t = getattr(obj, f)
        if t.ndim >= 2 and name.rsplit(".", 1)[-1] != "pos":
            return t.shape[0]
    raise ValueError("could not infer batch from cache tree")
