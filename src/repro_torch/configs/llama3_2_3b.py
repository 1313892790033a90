"""llama3.2-3b — small llama3 dense.

[hf:meta-llama/Llama-3.2-1B (family); unverified] 28L d_model=3072 24H
(GQA kv=8) d_ff=8192 vocab=128256, tied embeddings, rope_theta=500000.
Quadratic ⇒ skips ``long_500k``. 24 heads do not divide the 16-way model
axis — the sharding rules fall back to d_ff/d_model TP with padded head
sharding for attention (DESIGN §5).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=128_256,
    pattern=("attn",),
    rope_theta=500_000.0,
    mlp_act="silu_glu",
    tie_embeddings=True,
    subquadratic=False,
    microbatches=4,
    # 24 heads don't shard over the 16-way TP axis → prefill scores stay
    # head-replicated; smaller query chunks bound the (C, S) buffer
    attn_chunk=512,
)

SMOKE = ModelConfig(
    name="llama3.2-3b-smoke",
    family="dense",
    n_layers=2,
    d_model=48,
    n_heads=6,      # preserves the non-power-of-two head count family trait
    n_kv_heads=2,
    head_dim=8,
    d_ff=128,
    vocab=256,
    pattern=("attn",),
    mlp_act="silu_glu",
    tie_embeddings=True,
    subquadratic=False,
    param_dtype="float32",
    compute_dtype="float32",
)

register(CONFIG, SMOKE)
