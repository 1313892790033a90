"""mamba2-1.3b — attention-free SSM (SSD, state-space duality).

[arXiv:2405.21060; unverified] 48L d_model=2048 vocab=50280,
ssm_state=128, headdim=64 ⇒ 64 SSD heads, expand=2 (d_inner=4096),
ngroups=1, conv width 4. Attention-free, O(1) decode state ⇒ runs
``long_500k``.

DESIGN §Arch-applicability: SSD's chunked formulation IS the paper's
memory-locality insight applied to sequence mixing — intra-chunk blocked
matmuls + O(chunks) inter-chunk recurrence instead of a length-N scan.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    # true vocab 50280, padded to a multiple of the 16-way TP axis
    vocab=50_288,
    pattern=("ssd",),
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_chunk=256,
    conv_width=4,
    tie_embeddings=True,
    subquadratic=True,
    microbatches=4,
)

SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=256,
    pattern=("ssd",),
    ssm_state=16,
    ssm_headdim=16,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_chunk=8,
    conv_width=4,
    tie_embeddings=True,
    subquadratic=True,
    param_dtype="float32",
    compute_dtype="float32",
)

register(CONFIG, SMOKE)
