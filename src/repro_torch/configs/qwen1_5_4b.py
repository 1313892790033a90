"""qwen1.5-4b — dense with QKV bias, MHA (kv == heads).

[hf:Qwen/Qwen1.5-0.5B (family); hf] 40L d_model=2560 20H (GQA kv=20)
d_ff=6912 vocab=151936, QKV bias. Quadratic ⇒ skips ``long_500k``.
20 heads do not divide the 16-way model axis — padded head sharding.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab=151_936,
    pattern=("attn",),
    qkv_bias=True,
    mlp_act="silu_glu",
    tie_embeddings=False,
    subquadratic=False,
    microbatches=4,
    # 20 heads don't shard over the 16-way TP axis (see llama3.2-3b)
    attn_chunk=512,
)

SMOKE = ModelConfig(
    name="qwen1.5-4b-smoke",
    family="dense",
    n_layers=2,
    d_model=40,
    n_heads=5,
    n_kv_heads=5,
    head_dim=8,
    d_ff=96,
    vocab=256,
    pattern=("attn",),
    qkv_bias=True,
    mlp_act="silu_glu",
    tie_embeddings=False,
    subquadratic=False,
    param_dtype="float32",
    compute_dtype="float32",
)

register(CONFIG, SMOKE)
