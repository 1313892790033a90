"""Parity of the port's LM layers and configs with the reference's
(``repro.models.layers``, ``repro.configs``), on the same numpy inputs.

Tolerances: rtol 1e-5 / atol 1e-5 in fp32 for rope, layernorm, the MLPs
and the head (the same formulas; products summed in another order, sin/cos
and the rope frequencies' pow from another library); in bf16, rope to
within 1 bf16 ulp (both round one fp32 rotation, which may differ by an
ulp). The gather embedding equals the reference's one-hot einsum exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro import configs as ref_configs
from repro.models import layers as ref
from repro_torch import configs
from repro_torch.kernels.rmsnorm_ref import bf16_ulp_distance
from repro_torch.models import attention, layers

PORTED = ("qwen3-8b", "llama3.2-3b", "qwen1.5-4b", "nemotron-4-340b",
          "granite-moe-1b-a400m", "grok-1-314b", "phi-3-vision-4.2b",
          "mamba2-1.3b", "recurrentgemma-9b", "seamless-m4t-medium")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("name", PORTED)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_the_reference_field_for_field(name, smoke):
    mine = configs.get_arch(name, smoke=smoke)
    theirs = ref_configs.get_arch(name, smoke=smoke)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.param_count() == theirs.param_count()
    assert mine.layer_types() == theirs.layer_types()
    assert mine.dtype() == getattr(torch, theirs.dtype().name)
    assert mine.dtype("opt") == getattr(torch, theirs.dtype("opt").name)


def test_config_fields_and_shapes_are_the_reference_s():
    assert [f.name for f in dataclasses.fields(configs.ModelConfig)] == \
        [f.name for f in dataclasses.fields(ref_configs.ModelConfig)]
    assert configs.SHAPES == {k: configs.ShapeConfig(*dataclasses.astuple(v))
                              for k, v in ref_configs.SHAPES.items()}


def test_get_arch_says_which_archs_wait():
    """None waits: every reference arch resolves, full and smoke."""
    assert set(configs.ARCHS) == set(configs.SMOKES) == set(PORTED) == \
        set(ref_configs.ARCHS) == set(ref_configs.SMOKES)
    for name in sorted(ref_configs.ARCHS):
        for smoke in (False, True):
            assert configs.get_arch(name, smoke=smoke).name == \
                ref_configs.get_arch(name, smoke=smoke).name
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch("gpt-2")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(dtype, theta):
    rng = np.random.default_rng(int(theta) % 97)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 600, (2, 9)).astype(np.int32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = ref.apply_rope(jx, jnp.asarray(pos), theta)
    got = layers.apply_rope(_t(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)), torch.from_numpy(pos), theta)
    assert got.dtype == getattr(torch, dtype)
    want = _t(np.asarray(want.astype(jnp.float32)))
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert int(bf16_ulp_distance(got, want).max()) <= 1
    np.testing.assert_allclose(
        layers.rope_frequencies(16, theta).numpy(),
        np.asarray(ref.rope_frequencies(16, theta)), rtol=1e-6)


@pytest.mark.parametrize("act", ["silu_glu", "gelu_glu", "sq_relu"])
def test_mlp_matches_reference(act):
    cfg = dataclasses.replace(configs.get_arch("qwen3-8b", smoke=True),
                              mlp_act=act)
    rcfg = dataclasses.replace(ref_configs.get_arch("qwen3-8b", smoke=True),
                               mlp_act=act)
    rng = np.random.default_rng(3)
    d, f = cfg.d_model, cfg.d_ff
    weights = {"w_up": rng.standard_normal((d, f)) * d ** -0.5,
               "w_down": rng.standard_normal((f, d)) * f ** -0.5}
    if act != "sq_relu":
        weights["w_gate"] = rng.standard_normal((d, f)) * d ** -0.5
    weights = {k: v.astype(np.float32) for k, v in weights.items()}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    m = layers.MLP(cfg, d, f, "cpu")
    m.load_state_dict({k: _t(v) for k, v in weights.items()})
    got = m(_t(x))
    want = ref.mlp({k: jnp.asarray(v) for k, v in weights.items()},
                   jnp.asarray(x), rcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_init_draws_at_the_reference_scales():
    cfg = configs.get_arch("qwen3-8b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    m = layers.MLP(cfg, 64, 4096, "cpu")
    e = layers.Embedding(dataclasses.replace(cfg, vocab=4096), "cpu")
    a = attention.Attention(dataclasses.replace(
        cfg, d_model=256, n_heads=8, n_kv_heads=8, head_dim=32), "cpu")
    for module in (m, e, a):
        module.reset_parameters(gen)
    for t, scale in ((m.w_gate, 64 ** -0.5), (m.w_up, 64 ** -0.5),
                     (m.w_down, 4096 ** -0.5), (e.table, 64 ** -0.5),
                     (e.head, 64 ** -0.5), (a.wq, 256 ** -0.5),
                     (a.wk, 256 ** -0.5), (a.wv, 256 ** -0.5),
                     (a.wo, 256 ** -0.5)):
        assert abs(float(t.detach().std()) / scale - 1.0) < 0.02
        assert abs(float(t.detach().mean())) < 0.02 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tied", [False, True])
def test_embedding_gather_equals_the_one_hot_einsum(dtype, tied):
    base = configs.get_arch("qwen3-8b", smoke=True)
    cfg = dataclasses.replace(base, param_dtype=dtype, compute_dtype=dtype,
                              tie_embeddings=tied)
    rcfg = dataclasses.replace(ref_configs.get_arch("qwen3-8b", smoke=True),
                               param_dtype=dtype, compute_dtype=dtype,
                               tie_embeddings=tied)
    rng = np.random.default_rng(4)
    table = rng.standard_normal((cfg.vocab, cfg.d_model)).astype(np.float32)
    head = rng.standard_normal((cfg.vocab, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (3, 11)).astype(np.int32)
    jdt = getattr(jnp, dtype)
    rparams = {"table": jnp.asarray(table).astype(jdt)}
    state = {"table": _t(table).to(cfg.dtype())}
    if not tied:
        rparams["head"] = jnp.asarray(head).astype(jdt)
        state["head"] = _t(head).to(cfg.dtype())
    e = layers.Embedding(cfg, "cpu")
    e.load_state_dict(state)
    got = layers.embed_tokens(e, torch.from_numpy(tokens), cfg)
    want = ref.embed_tokens(rparams, jnp.asarray(tokens), rcfg)
    assert got.dtype == cfg.dtype()
    # bitwise: each one-hot row holds a single 1
    assert np.array_equal(got.detach().float().numpy(),
                          np.asarray(want.astype(jnp.float32)))
    if dtype == "float32":
        x = rng.standard_normal((3, 2, cfg.d_model)).astype(np.float32)
        got = layers.lm_logits(e, _t(x), cfg)
        want = ref.lm_logits(rparams, jnp.asarray(x), rcfg)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_layernorm_matches_reference():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4, 3, 40)) * 2 + 1).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(40)).astype(np.float32)
    b = (0.1 * rng.standard_normal(40)).astype(np.float32)
    got = layers.layernorm(_t(x), _t(w), _t(b))
    want = ref.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    cfg = dataclasses.replace(configs.get_arch("qwen3-8b", smoke=True),
                              norm="layernorm")
    norm = layers.init_norm(cfg, 40, "cpu")
    norm.load_state_dict({"w": _t(w), "b": _t(b)})
    assert torch.equal(norm(_t(x)), got)
