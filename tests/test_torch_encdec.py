"""Parity of the port's enc-dec model (``repro_torch.models.encdec``) and
cross-attention with ``repro.models.encdec`` and
``repro.models.attention`` on the same numpy weights and inputs, in fp32.

The weights are the reference's ``init_params_encdec`` at
seamless-m4t-medium's smoke widths (2 + 2 layers, d = 64, 4 heads of 16),
its layernorm scales and biases drawn away from 1 and 0 so that they act,
carried over by ``convert.lm_params_from_reference``; the reference runs
under ``jax.jit``. Tolerance: rtol 1e-5 / atol 1e-5 (the same formulas;
products and the softmax sum in another order). The cross K/V of the
decoder cache are computed once at prefill and held bitwise across the
decode steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro import configs as ref_configs
from repro.models import attention as ref_attn
from repro.models import encdec as ref
from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import attention as attn
from repro_torch.models import encdec

TOL = {"rtol": 1e-5, "atol": 1e-5}
NAME = "seamless-m4t-medium"
B, S_ENC, S_DEC, STEPS = 2, 6, 9, 4

ref_encode = jax.jit(ref.encode, static_argnums=(2,))
ref_train = jax.jit(ref.forward_train_encdec, static_argnums=(3,))
ref_prefill = jax.jit(ref.prefill_encdec, static_argnums=(3, 4))
ref_decode = jax.jit(ref.decode_step_encdec, static_argnums=(3,))


def _cfgs(**changes):
    return (dataclasses.replace(configs.get_arch(NAME, smoke=True),
                                **changes),
            dataclasses.replace(ref_configs.get_arch(NAME, smoke=True),
                                **changes))


def _reference_params(rcfg, seed):
    params = ref.init_params_encdec(jax.random.PRNGKey(seed), rcfg)
    rng = np.random.default_rng(seed)

    def acting(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith(("'w']", "'b']")):
            base = 1.0 if name.endswith("'w']") else 0.0
            return jnp.asarray((base + 0.1 * rng.standard_normal(
                leaf.shape)).astype(np.float32))
        return leaf
    return jax.tree_util.tree_map_with_path(acting, params)


def _both(seed=0):
    cfg, rcfg = _cfgs()
    params = _reference_params(rcfg, seed)
    model = encdec.EncDec(cfg, "cpu")
    model.load_state_dict(lm_params_from_reference(
        jax.tree.map(np.asarray, params), cfg, "cpu"))
    return cfg, rcfg, model, params


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, S_ENC, cfg.frontend_dim)).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab, (B, S_DEC + STEPS)).astype(np.int32)
    return frames, tokens


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_encode_and_train_forward_match_reference():
    cfg, rcfg, model, params = _both(1)
    frames, tokens = _inputs(cfg, 1)
    _close(encdec.encode(model, torch.from_numpy(frames), cfg),
           ref_encode(params, jnp.asarray(frames), rcfg))
    hidden, aux = encdec.forward_train_encdec(
        model, torch.from_numpy(frames), torch.from_numpy(tokens), cfg)
    want, waux = ref_train(params, jnp.asarray(frames), jnp.asarray(tokens),
                           rcfg)
    _close(hidden, want)
    assert float(aux) == float(waux) == 0.0


def test_prefill_and_decode_match_reference():
    """Prefill (its self and cross caches) and STEPS decode steps; the
    cross K/V bitwise unchanged by the steps."""
    cfg, rcfg, model, params = _both(2)
    frames, tokens = _inputs(cfg, 2)
    max_len = S_DEC + STEPS
    hidden, cache = encdec.prefill_encdec(
        model, torch.from_numpy(frames), torch.from_numpy(tokens[:, :S_DEC]),
        cfg, max_len)
    want, wcache = ref_prefill(params, jnp.asarray(frames),
                               jnp.asarray(tokens[:, :S_DEC]), rcfg, max_len)
    _close(hidden, want)
    assert cache.pos == int(wcache["pos"]) == S_DEC
    for i, c in enumerate(cache.dec):
        _close(c.cross_k, wcache["dec"]["cross_k"][i])
        _close(c.cross_v, wcache["dec"]["cross_v"][i])
        _close(c.self_attn.k, wcache["dec"]["self"]["k"][i])
        assert np.array_equal(c.self_attn.pos.numpy(),
                              np.asarray(wcache["dec"]["self"]["pos"][i]))
    cross = [(c.cross_k.clone(), c.cross_v.clone()) for c in cache.dec]
    for t in range(S_DEC, S_DEC + STEPS):
        h, cache = encdec.decode_step_encdec(
            model, torch.from_numpy(tokens[:, t:t + 1]), cache, cfg)
        wh, wcache = ref_decode(params, jnp.asarray(tokens[:, t:t + 1]),
                                wcache, rcfg)
        _close(h, wh)
    assert cache.pos == S_DEC + STEPS
    for (k, v), c in zip(cross, cache.dec):
        assert torch.equal(k, c.cross_k) and torch.equal(v, c.cross_v)
    for i, c in enumerate(cache.dec):
        _close(c.self_attn.v, wcache["dec"]["self"]["v"][i])


def test_decode_from_an_empty_cache_shapes_are_the_reference_s():
    cfg, rcfg = _cfgs()
    cache = encdec.init_cache_encdec(cfg, B, 16, S_ENC, "cpu")
    want = ref.init_cache_encdec(rcfg, B, 16, S_ENC)
    assert len(cache.dec) == cfg.n_layers and cache.pos == 0
    for c in cache.dec:
        assert tuple(c.cross_k.shape) == want["dec"]["cross_k"].shape[1:]
        assert tuple(c.self_attn.k.shape) == \
            want["dec"]["self"]["k"].shape[1:]


@pytest.mark.parametrize("sq", [5, 3072], ids=["one-pass", "chunked"])
def test_cross_attention_matches_reference(sq):
    """``attn_forward(kv_x=, causal=False)`` (no rope on either side) in
    one pass and in query chunks, and ``attn_decode_cross``."""
    cfg, rcfg = _cfgs()
    w = jax.tree.map(np.asarray, ref_attn.init_attn(jax.random.PRNGKey(3),
                                                    rcfg))
    p = attn.Attention(cfg, "cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in w.items()})
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, sq, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((1, 7, cfg.d_model)).astype(np.float32)
    out, (k, v) = attn.attn_forward(p, torch.from_numpy(x), None, cfg,
                                    causal=False,
                                    kv_x=torch.from_numpy(enc))
    want, (wk, wv) = jax.jit(
        lambda pp, xx, ee: ref_attn.attn_forward(
            pp, xx, None, rcfg, causal=False, kv_x=ee))(
        w, jnp.asarray(x), jnp.asarray(enc))
    _close(out, want)
    _close(k, wk)
    _close(v, wv)
    step = attn.attn_decode_cross(p, torch.from_numpy(x[:, :1]), (k, v), cfg)
    wstep = ref_attn.attn_decode_cross(w, jnp.asarray(x[:, :1]), (wk, wv),
                                       rcfg)
    _close(step, wstep)


def test_non_causal_self_attention_matches_reference():
    """The encoder's attention: positions (rope) and no mask."""
    cfg, rcfg = _cfgs()
    w = jax.tree.map(np.asarray, ref_attn.init_attn(jax.random.PRNGKey(4),
                                                    rcfg))
    p = attn.Attention(cfg, "cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in w.items()})
    x = np.random.default_rng(4).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    out, _ = attn.attn_forward(p, torch.from_numpy(x), torch.from_numpy(pos),
                               cfg, causal=False)
    want, _ = ref_attn.attn_forward(w, jnp.asarray(x), jnp.asarray(pos),
                                    rcfg, causal=False)
    _close(out, want)
    causal, _ = attn.attn_forward(p, torch.from_numpy(x),
                                  torch.from_numpy(pos), cfg)
    assert not torch.allclose(causal, out)


def test_encoder_and_decoder_blocks_are_checkpointed_under_autograd(
        monkeypatch):
    """Every encoder and decoder block runs under ``checkpoint`` when
    autograd records, and none does under ``no_grad``."""
    cfg, _, model, _ = _both(5)
    frames, tokens = _inputs(cfg, 5)
    calls = []
    real = encdec.checkpoint

    def counted(fn, *args, **kwargs):
        calls.append(fn.__name__)
        return real(fn, *args, **kwargs)
    monkeypatch.setattr(encdec, "checkpoint", counted)
    hidden, _ = encdec.forward_train_encdec(
        model, torch.from_numpy(frames), torch.from_numpy(tokens), cfg)
    hidden.sum().backward()
    assert calls == ["_enc_block"] * cfg.n_enc_layers + \
        ["_dec_block"] * cfg.n_layers
    assert all(p.grad is not None for p in model.parameters())
    calls.clear()
    with torch.no_grad():
        encdec.forward_train_encdec(model, torch.from_numpy(frames),
                                    torch.from_numpy(tokens), cfg)
    assert calls == []
