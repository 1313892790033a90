"""seamless-m4t-medium — encoder-decoder, audio frontend (STUB).

[arXiv:2308.11596; hf] 12L encoder + 12L decoder, d_model=1024 16H
(kv=16, MHA) d_ff=4096 vocab=256206. The w2v-BERT audio frontend is a
STUB per the harness rules: ``input_specs()`` supplies precomputed frame
embeddings (B, seq/4, 1024); the backbone encoder consumes them through a
learned projection. Decoder: causal self-attention + cross-attention.
Quadratic decoder ⇒ skips ``long_500k``; runs decode shapes (enc-dec has
a decode step).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,               # decoder layers
    n_enc_layers=12,
    is_encdec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    # true vocab 256206, padded to a multiple of the 16-way TP axis
    # (standard TP practice; ids ≥ 256206 unused)
    vocab=256_208,
    pattern=("attn",),
    mlp_act="gelu_glu",
    frontend="audio",
    frontend_dim=1024,
    enc_len_ratio=4,
    norm="layernorm",
    tie_embeddings=True,
    subquadratic=False,
    microbatches=2,
)

SMOKE = ModelConfig(
    name="seamless-m4t-medium-smoke",
    family="audio",
    n_layers=2,
    n_enc_layers=2,
    is_encdec=True,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    pattern=("attn",),
    mlp_act="gelu_glu",
    frontend="audio",
    frontend_dim=32,
    enc_len_ratio=4,
    norm="layernorm",
    tie_embeddings=True,
    subquadratic=False,
    param_dtype="float32",
    compute_dtype="float32",
)

register(CONFIG, SMOKE)
