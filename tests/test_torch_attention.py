"""Parity of the port's attention (``repro_torch.models.attention``) with
``repro.models.attention`` on the same numpy weights and inputs, in fp32.

Tolerance: rtol 1e-5 / atol 1e-5 on outputs, K/V and caches (the same
formulas; products and the softmax sum in another order). The masks, the
cache positions and the slot writes are compared exactly. Zero-initialised
parameters (QKV biases, q/k norm weights) are drawn non-zero here so that
each variant acts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref
from repro_torch import configs
from repro_torch.models import attention as attn

VARIANTS = {"qwen3-8b": "qk-norm, GQA 4:2", "llama3.2-3b": "GQA 6:2",
            "qwen1.5-4b": "QKV bias, MHA"}
TOL = {"rtol": 1e-5, "atol": 1e-5}

# the reference, compiled once a shape (eager JAX dispatches op by op)
ref_forward = jax.jit(ref.attn_forward, static_argnums=(3,))
ref_decode = jax.jit(ref.attn_decode, static_argnums=(4,))


def _cfgs(name, **changes):
    return (dataclasses.replace(configs.get_arch(name, smoke=True), **changes),
            dataclasses.replace(ref_configs.get_arch(name, smoke=True),
                                **changes))


def _weights(cfg, seed):
    """The reference's attention params as numpy, every leaf non-zero."""
    p = jax.tree.map(np.asarray, ref.init_attn(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for key in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if key in p:
            p[key] = (0.2 * rng.standard_normal(p[key].shape)).astype(
                np.float32)
    return p


def _port(cfg, weights):
    p = attn.Attention(cfg, "cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in weights.items()})
    return p


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_attn_forward_matches_reference(name):
    cfg, rcfg = _cfgs(name)
    weights = _weights(rcfg, 1)
    x = np.random.default_rng(2).standard_normal(
        (2, 10, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))
    out, (k, v) = attn.attn_forward(_port(cfg, weights), torch.from_numpy(x),
                                    torch.from_numpy(pos.copy()), cfg)
    want, (wk, wv) = ref_forward(
        jax.tree.map(jnp.asarray, weights), jnp.asarray(x), jnp.asarray(pos),
        rcfg)
    _close(out, want)
    _close(k, wk)
    _close(v, wv)


def test_chunked_pass_matches_reference():
    """S = 3072 > max(attn_chunk, 2048): the loop over query chunks of
    1024, against the reference's scan over the same chunks."""
    changes = {"d_model": 32, "n_heads": 4, "n_kv_heads": 2, "head_dim": 8,
               "attn_chunk": 1024}
    cfg, rcfg = _cfgs("qwen3-8b", **changes)
    weights = _weights(rcfg, 3)
    s = 3072
    x = np.random.default_rng(4).standard_normal((1, s, 32)).astype(
        np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    p = _port(cfg, weights)
    out, _ = attn.attn_forward(p, torch.from_numpy(x), torch.from_numpy(pos),
                               cfg)
    want, _ = ref_forward(jax.tree.map(jnp.asarray, weights),
                          jnp.asarray(x), jnp.asarray(pos), rcfg)
    _close(out, want)
    # the chunks tile the single pass's result
    one_pass = dataclasses.replace(cfg, attn_chunk=s)
    whole, _ = attn.attn_forward(p, torch.from_numpy(x),
                                 torch.from_numpy(pos), one_pass)
    torch.testing.assert_close(out, whole, **TOL)


@pytest.mark.parametrize("sq,skv,offset", [(5, 5, 0), (4, 9, 5), (6, 6, 2),
                                           (3, 12, 7)])
def test_causal_mask_matches_reference(sq, skv, offset):
    got = attn._causal_mask(sq, skv, offset)
    want = ref._causal_mask(sq, skv, offset)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_prefill_cache_and_decode_match_reference(name):
    cfg, rcfg = _cfgs(name)
    weights = _weights(rcfg, 7)
    jweights = jax.tree.map(jnp.asarray, weights)
    p = _port(cfg, weights)
    b, s, max_len, steps = 2, 6, 10, 3
    x = np.random.default_rng(8).standard_normal(
        (b, s + steps, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    _, (k, v) = attn.attn_forward(p, torch.from_numpy(x[:, :s]),
                                  torch.from_numpy(pos), cfg)
    cache = attn.fill_cache_from_prefill(
        attn.init_attn_cache(cfg, b, max_len, device="cpu"), k, v)
    _, (wk, wv) = ref_forward(jweights, jnp.asarray(x[:, :s]),
                              jnp.asarray(pos), rcfg)
    want = ref.fill_cache_from_prefill(
        ref.init_attn_cache(rcfg, b, max_len), wk, wv)
    for t in range(s, s + steps):
        out, cache = attn.attn_decode(p, torch.from_numpy(x[:, t:t + 1]),
                                      cache, t, cfg)
        wout, want = ref_decode(jweights, jnp.asarray(x[:, t:t + 1]),
                                want, jnp.int32(t), rcfg)
        _close(out, wout)
    _close(cache.k, want["k"])
    _close(cache.v, want["v"])
    assert np.array_equal(cache.pos.numpy(), np.asarray(want["pos"]))


def test_unported_variants_raise_naming_the_roadmap():
    cfg, _ = _cfgs("qwen3-8b")
    cache = attn.init_attn_cache(cfg, 1, 4, device="cpu")
    x = torch.zeros((1, 1, cfg.d_model))
    pos = torch.zeros((1, 1), dtype=torch.int32)
    p = attn.Attention(cfg, "cpu")
    calls = [
        lambda: attn.attn_forward(p, x, pos, cfg, window=2),
        lambda: attn.init_attn_cache(dataclasses.replace(cfg, kv_quant=True),
                                     1, 4, device="cpu"),
        lambda: attn.init_attn_cache(cfg, 1, 4, window=2, device="cpu"),
        lambda: attn.fill_cache_from_prefill(cache, x, x, window=2),
        lambda: attn.attn_decode(p, x, cache, 0, cfg, window=2),
        lambda: attn.attn_decode_cross(p, x, (x, x), cfg),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            call()
    with pytest.raises(ValueError, match="outside the cache"):
        attn.attn_decode(p, x, cache, 4, cfg)
