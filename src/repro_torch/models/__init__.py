"""The LM stack: decoders for serving and training, and the one place that
picks a config's model family.

The counterpart of ``repro/models``: ``layers`` (norms, rotary embeddings,
MLPs, embedding and head), ``attention`` (GQA/MQA/MHA with qk-norm and QKV
bias, the KV cache, cross-attention), ``moe``, ``rglru`` and ``ssd`` (the
recurrent mixers), ``transformer`` (the decoder-only stack, its three entry
points and the training forward's remat) and ``encdec`` (the
encoder-decoder). Every RMSNorm reaches the ``rmsnorm`` kernel on a CUDA
tensor, and under autograd its backward kernel.

The functions below hand a config to its family: ``encdec``'s ``EncDec``
for an enc-dec config, else ``transformer``'s ``Transformer``. Serving,
training and their tests call them rather than asking ``cfg.is_encdec``.
A family's input beside the tokens, ``extra``, is an enc-dec model's frame
embeddings (B, S_enc, frontend_dim) or a vision model's patch embeddings
(B, n_patches, frontend_dim), and ``None`` for the others.
"""

from __future__ import annotations

from repro_torch.models import encdec, transformer


def build_model(cfg, device=None):
    """An uninitialised model of ``cfg`` on ``device`` (the card unless
    "cpu" or "meta")."""
    return (encdec.EncDec if cfg.is_encdec
            else transformer.Transformer)(cfg, device)


def init_model(cfg, generator, device=None):
    """The model of ``cfg`` with its weights drawn from ``generator``."""
    return (encdec.init_params_encdec if cfg.is_encdec
            else transformer.init_params)(cfg, generator, device)


def extra_input(cfg, batch: dict):
    """``batch``'s entry beside the tokens that ``cfg``'s model takes:
    ``"frames"`` for an enc-dec model, ``"patches"`` for a vision one,
    else ``None``."""
    if cfg.is_encdec:
        return batch["frames"]
    return batch["patches"] if cfg.frontend == "vision" else None


def forward_train(model, tokens, cfg, extra=None):
    """→ (hidden, aux): the training forward of ``cfg``'s family."""
    if cfg.is_encdec:
        return encdec.forward_train_encdec(model, extra, tokens, cfg)
    return transformer.forward_train(model, tokens, cfg, extra)


def prefill(model, tokens, cfg, extra=None, max_len=None):
    """→ (hidden, cache): the prefill of ``cfg``'s family; ``max_len``
    counts the decoder's positions (a vision model's patches among
    them)."""
    if cfg.is_encdec:
        return encdec.prefill_encdec(model, extra, tokens, cfg,
                                     max_len=max_len)
    return transformer.prefill(model, tokens, cfg, extra, max_len=max_len)


def decode_step(model, token, cache, cfg):
    """→ (hidden, cache): one decode step of ``cfg``'s family, the cache
    updated in place."""
    step = (encdec.decode_step_encdec if cfg.is_encdec
            else transformer.decode_step)
    return step(model, token, cache, cfg)
