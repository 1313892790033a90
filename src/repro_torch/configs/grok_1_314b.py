"""grok-1-314b — MoE, 8 experts top-2.

[hf:xai-org/grok-1; unverified] 64L d_model=6144 48H (GQA kv=8)
d_ff=32768 (per expert) vocab=131072, MoE 8e top-2, attention logit
softcap 30 (grok-style tanh cap). Quadratic ⇒ skips ``long_500k``.

Experts (8) do not divide the 16-way model axis, so the sharding rules
TP-shard the expert FFN hidden dim instead (DESIGN §5); m/v in bf16 for
the ≥100B memory budget.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32_768,
    vocab=131_072,
    pattern=("moe",),
    n_experts=8,
    top_k=2,
    attn_softcap=30.0,
    mlp_act="gelu_glu",
    tie_embeddings=True,
    subquadratic=False,
    opt_dtype="bfloat16",
    microbatches=8,
    moe_chunk=512,
)

SMOKE = ModelConfig(
    name="grok-1-314b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab=256,
    pattern=("moe",),
    n_experts=8,
    top_k=2,
    attn_softcap=30.0,
    mlp_act="gelu_glu",
    tie_embeddings=True,
    subquadratic=False,
    moe_chunk=16,
    param_dtype="float32",
    compute_dtype="float32",
)

register(CONFIG, SMOKE)
