"""nemotron-4-340b — dense, GQA + squared-ReLU MLP.

[arXiv:2402.16819; unverified] 96L d_model=18432 96H (GQA kv=8)
d_ff=73728 vocab=256000, squared-ReLU (two-matrix) MLP, untied embeddings.
Quadratic ⇒ skips ``long_500k``.

Largest assigned arch (~341B params): m/v kept in bf16 and 16-way grad
accumulation so the 256-chip pod fits (DESIGN §5 memory budget:
341e9 × 8 B / 256 ≈ 10.7 GB/chip for param+grad+m+v).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18_432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73_728,
    vocab=256_000,
    pattern=("attn",),
    mlp_act="sq_relu",
    tie_embeddings=False,
    subquadratic=False,
    opt_dtype="bfloat16",
    microbatches=16,
)

SMOKE = ModelConfig(
    name="nemotron-4-340b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab=256,
    pattern=("attn",),
    mlp_act="sq_relu",
    tie_embeddings=False,
    subquadratic=False,
    param_dtype="float32",
    compute_dtype="float32",
)

register(CONFIG, SMOKE)
