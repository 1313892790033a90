"""LM loss, scanned over the sequence in chunks.

The counterpart of ``repro/runtime/loss.py::lm_loss``. The (B, S, V) logits
are the largest activation of a training step; the sequence is taken in
chunks of ``_LOSS_CHUNK`` positions, so at most a (B, C, V) block of logits
(and its fp32 copy) lives at once, with the reference's rule: the whole
sequence is one block when ``s % C`` or ``s <= C``. Each block's logits are
cast to fp32 for the logsumexp and the gold logit. The gold logit is a
gather, which equals the reference's one-hot einsum bitwise (each one-hot
row holds a single 1).

``rules`` (the reference's vocab-sharded logits on a mesh) wait for the LM
on a mesh (ROADMAP.md, item 13); ``None`` is the only value taken.
"""

from __future__ import annotations

import torch

_LOSS_CHUNK = 1024


def _nll_block(table: torch.Tensor, hidden: torch.Tensor,
               targets: torch.Tensor) -> torch.Tensor:
    """Sum of the NLL over one (B, C) block, fp32."""
    logits = (hidden @ table.T).float()                    # (B, C, V)
    logz = torch.logsumexp(logits, dim=-1)                 # (B, C)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.sum(logz - gold)


def lm_loss(embed_params, hidden: torch.Tensor, targets: torch.Tensor,
            cfg, rules=None) -> torch.Tensor:
    """hidden: (B, S, D); targets: (B, S) integers → the scalar mean NLL,
    fp32. ``embed_params`` is the model's ``Embedding`` (its ``table`` when
    the head is tied, else its ``head``). For a hidden sequence longer than
    the targets, the loss is taken on the trailing positions."""
    if rules is not None:
        raise NotImplementedError(
            "vocab-sharded logits wait for the LM on a mesh (ROADMAP.md, "
            "item 13); rules=None is the only value taken")
    s_text = targets.shape[1]
    if hidden.shape[1] != s_text:
        hidden = hidden[:, -s_text:]
    table = embed_params.table if cfg.tie_embeddings else embed_params.head

    b, s = targets.shape
    c = _LOSS_CHUNK
    if s % c or s <= c:
        return _nll_block(table, hidden, targets) / (b * s)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, c):
        total = total + _nll_block(table, hidden[:, i:i + c],
                                   targets[:, i:i + c])
    return total / (b * s)
