"""Config system: ModelConfig (one per assigned architecture), input shapes,
and the arch registry.

The counterpart of ``repro/configs/base.py``, copied field for field so a
config means the same in both packages; only ``dtype`` differs, returning
a ``torch.dtype``. Every field that differs across the 10 assigned
architectures is explicit here; per-arch files (``configs/<id>.py``)
instantiate exact configs from the public literature and a ``smoke()``
reduction of the same family.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


# --------------------------------------------------------------------------
# Input shapes (assigned set — same four for every LM arch)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


# --------------------------------------------------------------------------
# Model config
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128

    # attention variants
    qk_norm: bool = False          # qwen3
    qkv_bias: bool = False         # qwen1.5
    attn_softcap: float = 0.0      # grok-style tanh logit cap (0 = off)
    rope_theta: float = 10_000.0
    window: int = 0                # sliding-window size for "local" blocks

    # MLP variants
    mlp_act: str = "silu_glu"      # silu_glu | gelu_glu | sq_relu

    # layer pattern: tiled to n_layers. Types:
    #   attn  — global attention + MLP
    #   local — sliding-window attention + MLP
    #   rec   — RG-LRU recurrent block + MLP (recurrentgemma)
    #   moe   — global attention + MoE FFN
    #   ssd   — Mamba-2 SSD mixer (no separate MLP)
    pattern: Tuple[str, ...] = ("attn",)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_chunk: int = 1_024         # sequence chunk for dispatch memory bound

    # SSM (Mamba-2 SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_chunk: int = 256
    conv_width: int = 4

    # recurrent (RG-LRU)
    lru_width: int = 0             # 0 → d_model

    # encoder-decoder (seamless)
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_len_ratio: int = 4         # enc_len = seq_len // ratio (audio frames)

    # modality frontend STUB: "none" | "vision" | "audio"
    frontend: str = "none"
    frontend_dim: int = 1_024      # precomputed patch/frame embedding width
    n_patches: int = 1_024         # vision: patches folded into the sequence

    # embeddings / head
    tie_embeddings: bool = True
    norm: str = "rmsnorm"          # rmsnorm | layernorm

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    opt_dtype: str = "float32"     # Adam m/v (+bf16 for the ≥100B archs)

    # training-step shape knobs
    microbatches: int = 1          # grad-accumulation steps inside train_step
    remat: str = "full"            # full | dots | none
    attn_chunk: int = 1_024        # KV chunk for flash-style attention
    # int8 KV-cache quantization (serving): halves the decode memory
    # floor; per-(b, t, head) symmetric scales (§Perf Cell B)
    kv_quant: bool = False
    # sequence-parallel residual stream (Korthikanti et al.): the scan-saved
    # carry shards its seq axis over the TP axis (16× remat-stash cut);
    # GSPMD inserts the all-gather/reduce-scatter pair per layer.
    seq_shard_activations: bool = True

    # long_500k applicability: quadratic global attention ⇒ skip
    subquadratic: bool = False

    # ------------------------------------------------------------------
    @property
    def lru_width_actual(self) -> int:
        return self.lru_width or self.d_model

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def n_dec_layers(self) -> int:
        return self.n_layers

    def dtype(self, which: str = "param") -> torch.dtype:
        name = {"param": self.param_dtype, "compute": self.compute_dtype,
                "opt": self.opt_dtype}[which]
        return getattr(torch, name)

    def layer_types(self) -> Tuple[str, ...]:
        """The pattern tiled out to n_layers (decoder side for enc-dec)."""
        reps = -(-self.n_layers // len(self.pattern))
        return tuple((self.pattern * reps)[: self.n_layers])

    def supports_shape(self, shape: ShapeConfig) -> bool:
        if shape.name == "long_500k" and not self.subquadratic:
            return False
        return True

    def param_count(self) -> int:
        """Analytic parameter count (cross-checked by tests against init)."""
        d, hd = self.d_model, self.head_dim
        attn = (d * self.n_heads * hd) * 2 + (d * self.n_kv_heads * hd) * 2
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        if self.qk_norm:
            attn += 2 * hd
        n_mats = 2 if self.mlp_act == "sq_relu" else 3
        mlp = n_mats * d * self.d_ff
        moe = self.n_experts * n_mats * d * self.d_ff + d * self.n_experts
        dr = self.lru_width_actual
        rec = 2 * d * dr + dr * d + 2 * dr * dr + self.conv_width * dr + 3 * dr
        di, g, st, nh = self.d_inner, self.ssm_ngroups, self.ssm_state, self.ssm_nheads
        ssd = (2 * d * di + 2 * d * g * st + d * nh + di * d
               + self.conv_width * (di + 2 * g * st) + 3 * nh + di)
        np_ = 2 * d if self.norm == "layernorm" else d  # params per norm
        per_type = {"attn": attn + mlp + 2 * np_, "local": attn + mlp + 2 * np_,
                    "moe": attn + moe + 2 * np_, "rec": rec + mlp + 2 * np_,
                    "ssd": ssd + np_}
        total = sum(per_type[t] for t in self.layer_types())
        if self.is_encdec:
            enc_layer = attn + mlp + 2 * np_
            dec_layer = 2 * attn + mlp + 3 * np_  # self + cross attention
            total = (self.n_enc_layers * enc_layer
                     + self.n_layers * dec_layer + np_)  # + encoder final norm
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        total += np_  # final norm
        if self.frontend != "none":
            total += self.frontend_dim * d  # projection of stub embeddings
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        n_mats = 2 if self.mlp_act == "sq_relu" else 3
        inactive = ((self.n_experts - self.top_k) * n_mats * self.d_model
                    * self.d_ff)
        n_moe_layers = sum(1 for t in self.layer_types() if t == "moe")
        return self.param_count() - n_moe_layers * inactive


# --------------------------------------------------------------------------
# Registry (populated by configs/__init__.py importing the per-arch files)
# --------------------------------------------------------------------------
ARCHS: dict = {}
SMOKES: dict = {}


def register(cfg: ModelConfig, smoke: ModelConfig):
    ARCHS[cfg.name] = cfg
    SMOKES[cfg.name] = smoke
    return cfg
