"""The LM stack: dense decoders (``attn`` blocks) for serving and training.

The counterpart of ``repro/models`` for the blocks ported so far:
``layers`` (norms, rotary embeddings, MLPs, embedding and head),
``attention`` (GQA/MQA/MHA with qk-norm and QKV bias, the KV cache) and
``transformer`` (the stack, its three entry points and the training
forward's remat). Every norm reaches the ``rmsnorm`` kernel on a CUDA
tensor, and under autograd its backward kernel.
"""
