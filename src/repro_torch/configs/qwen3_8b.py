"""qwen3-8b — dense, qk_norm + GQA.

[hf:Qwen/Qwen3-8B; hf] 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936, per-head RMS qk-norm, rope_theta=1e6.
Quadratic ⇒ skips ``long_500k``.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12_288,
    vocab=151_936,
    pattern=("attn",),
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp_act="silu_glu",
    tie_embeddings=False,
    subquadratic=False,
    microbatches=4,
)

SMOKE = ModelConfig(
    name="qwen3-8b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    pattern=("attn",),
    qk_norm=True,
    mlp_act="silu_glu",
    tie_embeddings=False,
    subquadratic=False,
    param_dtype="float32",
    compute_dtype="float32",
)

register(CONFIG, SMOKE)
