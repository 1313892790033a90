"""LM loss, scanned over the sequence in chunks.

The counterpart of ``repro/runtime/loss.py::lm_loss``. The (B, S, V) logits
are the largest activation of a training step; the sequence is taken in
chunks of ``_LOSS_CHUNK`` positions, so at most a (B, C, V) block of logits
(and its fp32 copy) lives at once, with the reference's rule: the whole
sequence is one block when ``s % C`` or ``s <= C``. Each block's logits are
cast to fp32 for the logsumexp and the gold logit. The gold logit is a
gather, which equals the reference's one-hot einsum bitwise (each one-hot
row holds a single 1).

With ``rules`` inside a sharded step (``sharding.ctx.use_shards``) the
logits are vocab-sharded, as the reference's module exists to make them:
each rank computes its rows of the batch against its slice of the vocab on
the TP axis only, (B, C, V / tp), never the full (B, C, V). The
log-softmax's max and sum and the target logit are reduced over the TP
axis in rank order (``launch.mesh.pmax``, ``reduce_from``), and the
gradient of ``hidden`` is the sum over the TP axis of each slice's part
(``copy_to``: a collective inside autograd). Each rank's loss is its rows'
NLL over the global token count, so the ranks' losses sum to the mean. A
table whose vocab is not split (an axis of size 1, or a vocab the axis does
not divide) takes the path above, bitwise.
"""

from __future__ import annotations

import torch

from repro_torch.launch import mesh as mesh_mod
from repro_torch.sharding import ctx as shard_ctx

_LOSS_CHUNK = 1024


def _nll_block(table: torch.Tensor, hidden: torch.Tensor,
               targets: torch.Tensor) -> torch.Tensor:
    """Sum of the NLL over one (B, C) block, fp32."""
    logits = (hidden @ table.T).float()                    # (B, C, V)
    logz = torch.logsumexp(logits, dim=-1)                 # (B, C)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.sum(logz - gold)


def _nll_block_sharded(table: torch.Tensor, hidden: torch.Tensor,
                       targets: torch.Tensor, v0: int,
                       shards) -> torch.Tensor:
    """``_nll_block`` with ``table`` this rank's vocab slice on the TP axis
    (rows ``v0`` on): fp32 logits (B, C, V / tp), the logsumexp and the
    gold logit reduced over the axis."""
    mesh, tp = shards.mesh, shards.tp
    v_loc = table.shape[0]
    h = mesh_mod.copy_to(hidden, mesh, tp)
    logits = (h @ table.T).float()                         # (B, C, V/tp)
    top = mesh_mod.pmax(logits.detach().amax(dim=-1), mesh, tp)
    se = mesh_mod.reduce_from(torch.exp(logits - top[..., None]).sum(-1),
                              mesh, tp)
    logz = top + torch.log(se)
    t = targets.long() - v0
    mine = (t >= 0) & (t < v_loc)
    gold = torch.gather(logits, -1, t.clamp(0, v_loc - 1)[..., None])[..., 0]
    gold = mesh_mod.reduce_from(torch.where(mine, gold, 0.0), mesh, tp)
    return torch.sum(logz - gold)


def lm_loss(embed_params, hidden: torch.Tensor, targets: torch.Tensor,
            cfg, rules=None) -> torch.Tensor:
    """hidden: (B, S, D); targets: (B, S) integers → the scalar mean NLL,
    fp32. ``embed_params`` is the model's ``Embedding`` (its ``table`` when
    the head is tied, else its ``head``). For a hidden sequence longer than
    the targets, the loss is taken on the trailing positions. With
    ``rules`` in a sharded step, the rank's share of the mean over the
    global batch, its logits vocab-sharded (see the module's docstring)."""
    s_text = targets.shape[1]
    if hidden.shape[1] != s_text:
        hidden = hidden[:, -s_text:]
    name = "table" if cfg.tie_embeddings else "head"
    shards = shard_ctx.current_shards() if rules is not None else None
    if shards is None:
        table = getattr(embed_params, name)
        block, ranks = _nll_block, 1
    else:
        table, v0 = shard_ctx.vocab_rows(embed_params, name)
        ranks = shard_ctx.batch_ranks()
        block = _nll_block
        if table.shape[0] != cfg.vocab:
            def block(t, h, y):
                return _nll_block_sharded(t, h, y, v0, shards)

    b, s = targets.shape
    n = b * s * ranks
    c = _LOSS_CHUNK
    if s % c or s <= c:
        return block(table, hidden, targets) / n
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, c):
        total = total + block(table, hidden[:, i:i + c], targets[:, i:i + c])
    return total / n
