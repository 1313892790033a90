"""recurrentgemma-9b — hybrid RG-LRU + local attention, 1:2 pattern.

[arXiv:2402.19427 (Griffin); unverified] 38L d_model=4096 16H (GQA kv=1,
MQA) d_ff=12288 vocab=256000. Pattern: (rec, rec, local) tiled — two
RG-LRU recurrent blocks per local-attention block; window 2048.
Sub-quadratic (bounded attention window + O(1) recurrent state) ⇒ runs
``long_500k``.

Deviation noted in DESIGN §Arch-applicability: RG-LRU input/recurrence
gates use dense d_rnn×d_rnn weights here (upstream uses block-diagonal);
param count lands ~9.3B.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256_000,
    pattern=("rec", "rec", "local"),
    window=2048,
    mlp_act="gelu_glu",
    lru_width=4096,
    tie_embeddings=True,
    subquadratic=True,
    microbatches=4,
    attn_softcap=0.0,
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke",
    family="hybrid",
    n_layers=4,                     # keeps one full (rec, rec, local) period + 1
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab=256,
    pattern=("rec", "rec", "local"),
    window=16,
    mlp_act="gelu_glu",
    lru_width=64,
    tie_embeddings=True,
    subquadratic=True,
    param_dtype="float32",
    compute_dtype="float32",
)

register(CONFIG, SMOKE)
