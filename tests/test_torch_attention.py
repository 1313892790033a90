"""Parity of the port's attention (``repro_torch.models.attention``) with
``repro.models.attention`` on the same numpy weights and inputs, in fp32.

Tolerance: rtol 1e-5 / atol 1e-5 on outputs, K/V and caches (the same
formulas; products and the softmax sum in another order). The masks, the
cache positions and the slot writes (the ring's slot → position map
included) are compared exactly. The int8 cache: values within 1 unit (K/V
differ from the reference's by ~1e-6, so a value at a half step may round
the other way; the count that differ is bounded too), scales to rtol 1e-6,
the outputs to 1e-5. Zero-initialised parameters (QKV biases, q/k norm
weights) are drawn non-zero here so that each variant acts.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
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


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("sq,skv,offset", [(5, 5, 0), (4, 9, 5), (6, 6, 2),
                                           (3, 12, 7)])
def test_causal_mask_matches_reference(sq, skv, offset, window):
    got = attn._causal_mask(sq, skv, offset, window)
    want = ref._causal_mask(sq, skv, offset, window)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window", [3, 7, 12])
def test_local_forward_matches_reference(window):
    """A window (``local`` blocks) in one pass; 12 spans the sequence."""
    cfg, rcfg = _cfgs("qwen3-8b")
    weights = _weights(rcfg, 11)
    x = np.random.default_rng(12).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    out, (k, v) = attn.attn_forward(_port(cfg, weights), torch.from_numpy(x),
                                    torch.from_numpy(pos), cfg,
                                    window=window)
    want, (wk, wv) = jax.jit(partial(ref.attn_forward, window=window),
                             static_argnums=(3,))(
        jax.tree.map(jnp.asarray, weights), jnp.asarray(x), jnp.asarray(pos),
        rcfg)
    _close(out, want)
    _close(k, wk)


def test_local_chunked_pass_matches_reference():
    """S = 3072 with a window of 1500: the loop over query chunks of 1024,
    each chunk's mask narrowed by the window, against the reference's scan."""
    changes = {"d_model": 32, "n_heads": 4, "n_kv_heads": 2, "head_dim": 8,
               "attn_chunk": 1024}
    cfg, rcfg = _cfgs("qwen3-8b", **changes)
    weights = _weights(rcfg, 13)
    s, window = 3072, 1500
    x = np.random.default_rng(14).standard_normal((1, s, 32)).astype(
        np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    p = _port(cfg, weights)
    out, _ = attn.attn_forward(p, torch.from_numpy(x), torch.from_numpy(pos),
                               cfg, window=window)
    want, _ = jax.jit(partial(ref.attn_forward, window=window),
                      static_argnums=(3,))(
        jax.tree.map(jnp.asarray, weights), jnp.asarray(x), jnp.asarray(pos),
        rcfg)
    _close(out, want)
    whole, _ = attn.attn_forward(p, torch.from_numpy(x),
                                 torch.from_numpy(pos),
                                 dataclasses.replace(cfg, attn_chunk=s),
                                 window=window)
    torch.testing.assert_close(out, whole, **TOL)


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


def _prefill_then_decode(name, seed, b, s, max_len, steps, window=0,
                         **changes):
    """The port's and the reference's caches after a prefill of ``s``
    positions and ``steps`` decode steps, and each step's outputs."""
    cfg, rcfg = _cfgs(name, **changes)
    weights = _weights(rcfg, seed)
    jweights = jax.tree.map(jnp.asarray, weights)
    p = _port(cfg, weights)
    x = np.random.default_rng(seed + 1).standard_normal(
        (b, s + steps, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    _, (k, v) = attn.attn_forward(p, torch.from_numpy(x[:, :s]),
                                  torch.from_numpy(pos), cfg, window=window)
    cache = attn.fill_cache_from_prefill(
        attn.init_attn_cache(cfg, b, max_len, window=window, device="cpu"),
        k, v, window=window)
    _, (wk, wv) = ref_forward(jweights, jnp.asarray(x[:, :s]),
                              jnp.asarray(pos), rcfg)
    want = ref.fill_cache_from_prefill(
        ref.init_attn_cache(rcfg, b, max_len, window=window), wk, wv,
        window=window)
    decode = jax.jit(partial(ref.attn_decode, window=window),
                     static_argnums=(4,))
    outs = []
    for t in range(s, s + steps):
        out, cache = attn.attn_decode(p, torch.from_numpy(x[:, t:t + 1]),
                                      cache, t, cfg, window=window)
        wout, want = decode(jweights, jnp.asarray(x[:, t:t + 1]), want,
                            jnp.int32(t), rcfg)
        outs.append((out, wout))
    return cache, want, outs


@pytest.mark.parametrize("s,steps", [(10, 4), (3, 6)])
def test_ring_cache_prefill_and_decode_match_reference(s, steps):
    """A ring of 4 slots (window 4): a prompt longer than the ring keeps its
    last 4 positions at pos % 4; a short one fills slots [0, s) and decode
    evicts from there on. The slot → position map is the reference's
    exactly, after the prefill and after each step."""
    window, max_len = 4, 16
    cache, want, outs = _prefill_then_decode(
        "llama3.2-3b", 21, 2, s, max_len, steps, window=window)
    assert cache.k.shape[1] == min(window, max_len)
    for out, wout in outs:
        _close(out, wout)
    assert np.array_equal(cache.pos.numpy(), np.asarray(want["pos"]))
    assert sorted(cache.pos.tolist()) == list(range(s + steps - window,
                                                    s + steps))
    _close(cache.k, want["k"])
    _close(cache.v, want["v"])


def test_ring_prefill_slot_map_is_the_reference_s():
    """Prefill alone, past the ring: every slot's position and K/V."""
    cache, want, _ = _prefill_then_decode("qwen3-8b", 23, 2, 11, 32, 0,
                                          window=4)
    assert np.array_equal(cache.pos.numpy(), np.asarray(want["pos"]))
    assert cache.pos.tolist() == [8, 9, 10, 7]
    _close(cache.k, want["k"])
    _close(cache.v, want["v"])


def _int8_close(got: torch.Tensor, want) -> int:
    """int8 values within 1 unit; → how many differ."""
    diff = np.abs(got.detach().numpy().astype(np.int32)
                  - np.asarray(want).astype(np.int32))
    assert int(diff.max()) <= 1
    return int((diff > 0).sum())


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_int8_cache_matches_reference(name, window):
    """kv_quant: the prefill's and each decode step's int8 values within 1
    unit (at most 1 in 1000 differ), scales to rtol 1e-6, outputs to 1e-5;
    with a ring (window 4) too."""
    cache, want, outs = _prefill_then_decode(
        name, 25, 2, 6, 12, 4, window=window, kv_quant=True)
    assert cache.k.dtype == torch.int8 and cache.k_scale.dtype == \
        torch.float32
    for out, wout in outs:
        _close(out, wout)
    differ = _int8_close(cache.k, want["k"]) + _int8_close(cache.v,
                                                           want["v"])
    assert differ <= 2 * cache.k.numel() // 1000
    for key in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(cache, key).detach().numpy(),
                                   np.asarray(want[key]), rtol=1e-6,
                                   atol=1e-12)
    assert np.array_equal(cache.pos.numpy(), np.asarray(want["pos"]))


def test_quantize_kv_matches_reference():
    """The same fp32 K/V in: the int8 values and scales equal the
    reference's (rounding half to even, the 1e-8 floor, the ±127 clip)."""
    rng = np.random.default_rng(27)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                     # a zero row: the floored scale
    x[1, 2, 1, 3] = 40.0                 # a large outlier
    q, scale = attn._quantize_kv(torch.from_numpy(x))
    wq, wscale = ref._quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_allclose(scale.numpy(), np.asarray(wscale), rtol=1e-6)
    back = attn._dequantize_kv(q, scale, torch.float32)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(ref._dequantize_kv(wq, wscale,
                                                    jnp.float32)),
        rtol=1e-6)


def test_unported_variants_raise_naming_the_roadmap():
    """No variant waits: cross-attention (the enc-dec decoder's) equals the
    reference's in the forward and in decode; the cache still refuses a
    position or a prompt it cannot hold."""
    cfg, rcfg = _cfgs("qwen3-8b")
    weights = _weights(rcfg, 28)
    p = _port(cfg, weights)
    rng = np.random.default_rng(28)
    x = rng.standard_normal((1, 3, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((1, 5, cfg.d_model)).astype(np.float32)
    jw = jax.tree.map(jnp.asarray, weights)
    out, (k, v) = attn.attn_forward(p, torch.from_numpy(x), None, cfg,
                                    causal=False, kv_x=torch.from_numpy(enc))
    want, (wk, wv) = ref.attn_forward(jw, jnp.asarray(x), None, rcfg,
                                      causal=False, kv_x=jnp.asarray(enc))
    _close(out, want)
    _close(k, wk)
    _close(attn.attn_decode_cross(p, torch.from_numpy(x[:, :1]), (k, v),
                                  cfg),
           ref.attn_decode_cross(jw, jnp.asarray(x[:, :1]), (wk, wv), rcfg))
    cache = attn.init_attn_cache(cfg, 1, 4, device="cpu")
    x = torch.zeros((1, 1, cfg.d_model))
    with pytest.raises(ValueError, match="outside the cache"):
        attn.attn_decode(p, x, cache, 4, cfg)
    with pytest.raises(ValueError, match="exceeds the cache"):
        attn.fill_cache_from_prefill(cache, torch.zeros((1, 5, 2, 16)),
                                     torch.zeros((1, 5, 2, 16)))
