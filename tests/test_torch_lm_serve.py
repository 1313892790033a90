"""The LM serving slice as a whole: ``repro_torch.runtime.serve`` against
``repro.runtime.serve`` on the reference's own weights.

For each smoke config the reference's ``init_params`` draws the weights
(its zero-initialised norm weights and QKV biases are then drawn non-zero
with numpy, so each acts), ``convert.lm_params_from_reference`` carries
them over, and both packages prefill the same prompts and decode the same
six tokens. The MoE archs run at their own capacity (the prefill drops
pairs on both sides alike); phi-3-vision prefills random patch embeddings
before the prompt; seamless-m4t-medium encodes random frame embeddings
(``batch["frames"]``) and decodes against their cross K/V; mamba2-1.3b
(SSD blocks) and recurrentgemma-9b (RG-LRU and local blocks) carry their
recurrent states; a ``local`` config (qwen3-8b's smoke with the pattern
(attn, local) and a window of 4) and recurrentgemma-9b's smoke with a
window of 4 evict from their rings; and qwen3-8b's smoke serves from the
int8 cache.

Tolerances:
* fp32: logits to rtol 1e-4 / atol 1e-4 (the same formulas; products
  summed in another order through two layers), to 1e-5 for mamba2-1.3b,
  recurrentgemma-9b and seamless-m4t-medium (measured within 3e-6);
* bf16 (qwen3's smoke widths with bf16 params and activations): logits to
  atol 0.05·max|logits| with at least 0.999 correlation. The port's RMSNorm
  rounds once where the reference's rounds four times (up to 3 bf16 ulps a
  norm, ROADMAP.md queue 3), and the two libraries round bf16 products and
  activations at other places; measured 0.0093 of the scale, correlation
  0.99995;
* the port's decode against its own forward: rtol 2e-3 / atol 2e-3, the
  reference's tolerance for its own (tests/test_models.py), 3e-3 for
  recurrentgemma-9b's decode steps, whose sequence of 24 is longer than its
  window of 16, as there; the MoE archs made dropless (``capacity_factor
  = n_experts``) as there: a prefill drops pairs that a single decoded
  token never drops.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro import configs as ref_configs
from repro.models import encdec as ref_encdec
from repro.models import transformer as ref_tf
from repro.runtime import serve as ref_serve
from repro_torch import configs, models
from repro_torch.convert import FP32_LEAVES, lm_params_from_reference
from repro_torch.kernels import _build
from repro_torch.models import encdec
from repro_torch.models import transformer as tf
from repro_torch.runtime.serve import build_decode_fn, build_prefill_fn

ARCHS = ("qwen3-8b", "llama3.2-3b", "qwen1.5-4b", "nemotron-4-340b",
         "granite-moe-1b-a400m", "grok-1-314b", "phi-3-vision-4.2b",
         "mamba2-1.3b", "recurrentgemma-9b", "seamless-m4t-medium")
#: the SSD, RG-LRU and enc-dec archs, held to 1e-5 (measured within 3e-6)
RECURRENT_AND_ENCDEC = ("mamba2-1.3b", "recurrentgemma-9b",
                        "seamless-m4t-medium")
LOCAL = {"pattern": ("attn", "local"), "window": 4}   # qwen3-8b's smoke
PROMPT, STEPS, MAX_LEN, BATCH = 8, 6, 16, 2
BF16_ATOL = 0.05      # of max|logits|


def _cfgs(name, **changes):
    return (dataclasses.replace(configs.get_arch(name, smoke=True), **changes),
            dataclasses.replace(ref_configs.get_arch(name, smoke=True),
                                **changes))


#: the leaves the reference's init sets to 0 (or, for layernorm scales,
#: 1): drawn here so that each acts
ACTING = ("'w'", "'b'", "'bq'", "'bk'", "'bv'", "q_norm", "k_norm",
          "'norm_w'", "'b_a'", "'b_x'")


def _ref_init(rcfg):
    return ref_encdec.init_params_encdec if rcfg.is_encdec else \
        ref_tf.init_params


def _reference_params(rcfg, seed):
    """The reference's init, every zero-initialised leaf drawn non-zero."""
    params = _ref_init(rcfg)(jax.random.PRNGKey(seed), rcfg)
    rng = np.random.default_rng(seed)

    def nonzero(path, leaf):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ACTING):
            noise = 0.1 * rng.standard_normal(leaf.shape).astype(np.float32)
            return jnp.asarray(noise).astype(leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(nonzero, params)


def _port_model(cfg, params):
    model = models.build_model(cfg, "cpu")
    model.load_state_dict(lm_params_from_reference(
        jax.tree.map(np.asarray, params), cfg, "cpu"))
    return model


def _patches(cfg, b, seed, s=PROMPT):
    """A vision model's batch entry: random patch embeddings; an enc-dec
    model's: random frame embeddings, s // enc_len_ratio of them; else
    none."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        return {"frames": rng.standard_normal(
            (b, max(s // cfg.enc_len_ratio, 1), cfg.frontend_dim)).astype(
            np.float32)}
    if cfg.frontend != "vision":
        return {}
    return {"patches": rng.standard_normal(
        (b, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)}


def _n_patches(extra: dict) -> int:
    """Positions a batch's extra entry puts before the prompt."""
    return extra["patches"].shape[1] if "patches" in extra else 0


def _serve_both(name, **changes):
    """(port logits, reference logits): prefill then STEPS decode steps,
    each (BATCH, 1 + STEPS, vocab) as float32 numpy."""
    cfg, rcfg = _cfgs(name, **changes)
    params = _reference_params(rcfg, 0)
    model = _port_model(cfg, params)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, (BATCH, PROMPT + STEPS)).astype(np.int32)
    extra = _patches(cfg, BATCH, 2)
    max_len = MAX_LEN + _n_patches(extra)

    prefill = build_prefill_fn(cfg, max_len, device="cpu")
    decode = build_decode_fn(cfg, device="cpu")
    logits, cache = prefill(model, {"tokens": tokens[:, :PROMPT], **extra})
    got = [logits]
    for t in range(PROMPT, PROMPT + STEPS):
        logits, cache = decode(model, tokens[:, t:t + 1], cache)
        got.append(logits)
    assert cache.pos == max_len - MAX_LEN + PROMPT + STEPS

    ref_prefill = jax.jit(ref_serve.build_prefill_fn(rcfg, max_len))
    ref_decode = jax.jit(ref_serve.build_decode_fn(rcfg))
    logits, cache = ref_prefill(params, {
        "tokens": jnp.asarray(tokens[:, :PROMPT]),
        **{k: jnp.asarray(v) for k, v in extra.items()}})
    want = [logits]
    for t in range(PROMPT, PROMPT + STEPS):
        logits, cache = ref_decode(params, jnp.asarray(tokens[:, t:t + 1]),
                                   cache)
        want.append(logits)
    got = torch.cat(got, dim=1).float().numpy()
    want = np.concatenate([np.asarray(w.astype(jnp.float32)) for w in want],
                          axis=1)
    assert got.shape == want.shape == (BATCH, 1 + STEPS, cfg.vocab)
    return got, want


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference_fp32(name):
    got, want = _serve_both(name)
    tol = 1e-5 if name in RECURRENT_AND_ENCDEC else 1e-4
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("name,changes", [
    ("qwen3-8b", LOCAL), ("qwen3-8b", {"kv_quant": True}),
    ("recurrentgemma-9b", {"window": 4})],
    ids=["local-window-4", "int8-cache", "recurrentgemma-window-4"])
def test_attention_variants_serve_as_the_reference(name, changes):
    """qwen3-8b's smoke with local blocks whose ring the prompt overflows,
    and with the int8 cache; recurrentgemma's smoke with a ring of 4 that
    the prompt overflows, beside its recurrent states."""
    got, want = _serve_both(name, **changes)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_prefill_and_decode_match_reference_bf16():
    got, want = _serve_both("qwen3-8b", param_dtype="bfloat16",
                            compute_dtype="bfloat16")
    scale = float(np.abs(want).max())
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= BF16_ATOL * scale
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] >= 0.999


#: (batch, sequence, split) of the decode-against-forward check, as the
#: reference's tests/test_models.py takes them: recurrentgemma's sequence
#: is longer than its window of 16
DECODE_SPLIT = {"recurrentgemma-9b": (2, 24, 8),
                "seamless-m4t-medium": (2, 10, 5)}


@pytest.mark.parametrize("name", ARCHS + ("qwen3-8b local",))
def test_port_decode_matches_its_forward(name):
    cfg, _ = _cfgs(name.split()[0], **(LOCAL if "local" in name else {}))
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    gen = torch.Generator().manual_seed(2)
    model = models.init_model(cfg, gen, "cpu")
    b, s, split = DECODE_SPLIT.get(cfg.name.removesuffix("-smoke"),
                                   (2, 12, 6))
    tol = 3e-3 if cfg.window and "rec" in cfg.pattern else 2e-3
    tokens = torch.randint(0, cfg.vocab, (b, s),
                           generator=torch.Generator().manual_seed(3))
    extra = _patches(cfg, b, 4, s)
    p = _n_patches(extra)
    extra = models.extra_input(
        cfg, {k: torch.from_numpy(v) for k, v in extra.items()})
    with torch.no_grad():
        full, aux = models.forward_train(model, tokens, cfg, extra)
        called = ((extra, tokens) if cfg.is_encdec else (tokens, extra))
        assert torch.equal(model(*called)[0], full)
    assert (float(aux) > 0.0) == bool(cfg.n_experts)
    hidden, cache = models.prefill(model, tokens[:, :split], cfg, extra,
                                   max_len=p + s)
    torch.testing.assert_close(hidden, full[:, :p + split], rtol=2e-3,
                               atol=2e-3)
    for t in range(split, s):
        h, cache = models.decode_step(model, tokens[:, t:t + 1], cache, cfg)
        torch.testing.assert_close(h[:, 0], full[:, p + t], rtol=tol,
                                   atol=tol, msg=f"position {t}")


def test_decode_from_an_empty_cache_matches_prefill():
    cfg, _ = _cfgs("qwen3-8b")
    model = tf.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 5),
                           generator=torch.Generator().manual_seed(5))
    hidden, _ = tf.prefill(model, tokens, cfg)
    cache = tf.init_cache(cfg, 2, 5, device="cpu")
    for t in range(5):
        h, cache = tf.decode_step(model, tokens[:, t:t + 1], cache, cfg)
    torch.testing.assert_close(h[:, 0], hidden[:, -1], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", ARCHS)
def test_param_count_matches_the_init_and_the_reference(name):
    cfg, rcfg = _cfgs(name)
    gen = torch.Generator().manual_seed(0)
    model = models.init_model(cfg, gen, "cpu")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    # a block drawn alone holds what one layer of the model holds
    if cfg.is_encdec:
        pairs = ((encdec.EncBlock(cfg, "cpu"), model.enc_blocks[0]),
                 (encdec.DecBlock(cfg, "cpu"), model.dec_blocks[0]))
    else:
        pairs = tuple((tf.Block(cfg, t, "cpu"), model.blocks[i])
                      for i, t in enumerate(cfg.pattern))
    for block, layer in pairs:
        block.reset_parameters(torch.Generator().manual_seed(1))
        assert {k: v.shape for k, v in block.state_dict().items()} == \
            {k: v.shape for k, v in layer.state_dict().items()}
    full = configs.get_arch(name)
    assert full.param_count() == ref_configs.get_arch(name).param_count()
    # the converted reference init fills every parameter of the port, in
    # the port's dtypes (the fp32 leaves fp32)
    state = lm_params_from_reference(
        jax.tree.map(np.asarray, _ref_init(rcfg)(jax.random.PRNGKey(0),
                                                 rcfg)), cfg, "cpu")
    assert set(state) == set(model.state_dict())
    assert all(state[k].shape == v.shape and state[k].dtype == v.dtype
               for k, v in model.state_dict().items())


@pytest.mark.parametrize("name,count", [
    ("granite-moe-1b-a400m", 1_334_641_664),
    ("phi-3-vision-4.2b", 3_824_225_280),
    ("mamba2-1.3b", 1_343_548_416),
    ("recurrentgemma-9b", 9_396_301_824),
    ("seamless-m4t-medium", 716_517_376)])
def test_served_archs_are_the_published_size(name, count):
    """The archs served at full width and depth on one card: their
    parameter counts, built on the meta device, are the configs'; the fp32
    leaves are fp32 beside bf16 weights."""
    cfg = configs.get_arch(name)
    model = models.build_model(cfg, "meta")
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() == count
    fp32 = {n: p for n, p in model.named_parameters() if p.dtype ==
            torch.float32}
    assert all(n.endswith(FP32_LEAVES) for n in fp32)
    per_layer = {"moe": 1, "ssd": 3, "rec": 1}
    assert len(fp32) == sum(per_layer.get(t, 0) for t in cfg.layer_types()) \
        * (not cfg.is_encdec)


def test_qwen3_8b_is_the_published_size():
    cfg = configs.get_arch("qwen3-8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab) == (36, 4096, 32, 8, 128,
                                                  12288, 151936)
    assert cfg.qk_norm and not cfg.tie_embeddings
    assert 8.1e9 < cfg.param_count() < 8.3e9


def test_cpu_serving_launches_nothing_and_checks_the_device(monkeypatch):
    cfg, _ = _cfgs("llama3.2-3b")
    model = tf.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    _build.reset_launches()
    logits, cache = build_prefill_fn(cfg, 8, device="cpu")(
        model, {"tokens": np.zeros((1, 4), np.int32)})
    logits, cache = build_decode_fn(cfg, device="cpu")(
        model, np.zeros((1, 1), np.int64), cache)
    assert logits.shape == (1, 1, cfg.vocab) and cache.pos == 5
    assert set(_build.launches.values()) == {0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="generator"):   # before any draw
        tf.init_params(cfg, torch.Generator(), "cuda")
    with pytest.raises(ValueError, match="built for cuda"):
        build_prefill_fn(cfg, 8)(model, {"tokens": np.zeros((1, 4))})
    # every block type builds; an unknown one and a model of the wrong
    # kind are refused by name
    for btype in tf.PORTED_BLOCKS:
        tf.Block(configs.get_arch("recurrentgemma-9b", smoke=True), btype,
                 "cpu")
    with pytest.raises(ValueError, match="unknown block type"):
        tf.Block(cfg, "conv", "cpu")
    seamless = configs.get_arch("seamless-m4t-medium", smoke=True)
    with pytest.raises(ValueError, match="EncDec"):
        tf.Transformer(seamless, "cpu")
    with pytest.raises(ValueError, match="Transformer"):
        encdec.EncDec(cfg, "cpu")
