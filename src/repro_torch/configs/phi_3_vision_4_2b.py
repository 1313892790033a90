"""phi-3-vision-4.2b — phi3-mini backbone + CLIP vision frontend (STUB).

[hf:microsoft/Phi-3-vision-128k-instruct; hf] 32L d_model=3072 32H
(GQA kv=32, i.e. MHA) d_ff=8192 vocab=32064.

Per the assigned shape rules, the modality frontend is a STUB: the
caller supplies precomputed CLIP patch embeddings
(B, n_patches, 1024) which a learned projection folds into the token
sequence (first n_patches positions). Quadratic attention ⇒ skips
``long_500k``.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab=32_064,
    pattern=("attn",),
    mlp_act="silu_glu",
    frontend="vision",
    frontend_dim=1024,
    n_patches=1024,
    tie_embeddings=False,
    subquadratic=False,
    microbatches=4,
)

SMOKE = ModelConfig(
    name="phi-3-vision-4.2b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    pattern=("attn",),
    mlp_act="silu_glu",
    frontend="vision",
    frontend_dim=32,
    n_patches=8,
    tie_embeddings=False,
    subquadratic=False,
    param_dtype="float32",
    compute_dtype="float32",
)

register(CONFIG, SMOKE)
