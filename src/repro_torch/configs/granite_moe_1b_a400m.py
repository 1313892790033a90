"""granite-moe-1b-a400m — MoE, 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf] 24L d_model=1024 16H
(GQA kv=8) d_ff=512 (per expert) vocab=49155, MoE 32e top-8.
Quadratic ⇒ skips ``long_500k``. 32 experts divide the 16-way model axis
⇒ true expert parallelism (2 experts/device).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    # true vocab 49155, padded to a multiple of the 16-way TP axis
    vocab=49_168,
    pattern=("moe",),
    n_experts=32,
    top_k=8,
    mlp_act="silu_glu",
    tie_embeddings=True,
    subquadratic=False,
    moe_chunk=512,
    microbatches=2,
)

SMOKE = ModelConfig(
    name="granite-moe-1b-a400m-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab=256,
    pattern=("moe",),
    n_experts=8,
    top_k=4,
    mlp_act="silu_glu",
    tie_embeddings=True,
    subquadratic=False,
    moe_chunk=16,
    param_dtype="float32",
    compute_dtype="float32",
)

register(CONFIG, SMOKE)
