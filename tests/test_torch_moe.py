"""Parity of the port's MoE FFN (``repro_torch.models.moe``) with
``repro.models.moe`` on the same numpy weights and inputs.

Tolerances: in fp32, y and the aux loss to rtol 1e-5 / atol 1e-5 (the same
formulas; the port gathers each token's k expert outputs and sums them where
the reference contracts over (E, cap), so the sums run in another order).
The routing is compared exactly: each pair's expert (tie order included),
its slot in the expert and whether it is kept. The reference's routing is
read from its own lines (``repro/models/moe.py:60-70``) run here in JAX,
since ``moe_ffn`` returns only y and aux. In bf16 (the served dtype), y to
atol 0.02·max|y| (both round the expert products and activations to bf16,
in other places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro import configs as ref_configs
from repro.models import moe as ref
from repro_torch import configs
from repro_torch.models import moe

ARCHS = ("granite-moe-1b-a400m", "grok-1-314b")
TOL = {"rtol": 1e-5, "atol": 1e-5}

ref_moe_ffn = jax.jit(ref.moe_ffn, static_argnums=(2,))


def _cfgs(name, **changes):
    return (dataclasses.replace(configs.get_arch(name, smoke=True), **changes),
            dataclasses.replace(ref_configs.get_arch(name, smoke=True),
                                **changes))


def _weights(rcfg, seed):
    return jax.tree.map(np.asarray, ref.init_moe(jax.random.PRNGKey(seed),
                                                 rcfg))


def _port(cfg, weights):
    p = moe.MoE(cfg, "cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v, dtype=np.float32))
                       for k, v in weights.items()})
    return p


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


@jax.jit
def _ref_probs(x, router):
    return jax.nn.softmax(jnp.einsum("bcd,de->bce", x, router), axis=-1)


def _ref_routing(weights, x, cfg):
    """The reference's (ids, pos, keep) of one chunk, by its own lines."""
    b, c, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    probs = _ref_probs(jnp.asarray(x), jnp.asarray(weights["router"]))
    _, ids = jax.lax.top_k(probs, k)
    oh = jax.nn.one_hot(ids, e, dtype=jnp.int32)
    flat = oh.reshape(b, c * k, e)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos = jnp.sum(pos.reshape(b, c, k, e) * oh, axis=-1)
    keep = pos < ref._capacity(cfg, c)
    return np.asarray(ids), np.asarray(pos), np.asarray(keep)


def _both(name, s, seed, **changes):
    cfg, rcfg = _cfgs(name, **changes)
    weights = _weights(rcfg, seed)
    x = _x(cfg, 2, s, seed + 1)
    p = _port(cfg, weights)
    # x in the compute dtype: bf16 rounds it to the same values on both sides
    with torch.no_grad():
        y, aux = moe.moe_ffn(p, torch.from_numpy(x).to(cfg.dtype("compute")),
                             cfg)
    want_y, want_aux = ref_moe_ffn(
        jax.tree.map(jnp.asarray, weights),
        jnp.asarray(x).astype(rcfg.dtype("compute")), rcfg)
    return cfg, rcfg, weights, x, p, (y, aux), (want_y, want_aux)


@pytest.mark.parametrize("s,regime", [(16, "one chunk"),
                                      (48, "three chunks"),
                                      (20, "s % chunk: one chunk of 20")])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_ffn_matches_reference(name, s, regime):
    cfg, rcfg, weights, x, p, (y, aux), (want_y, want_aux) = _both(
        name, s, 3)
    assert cfg.moe_chunk == 16
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    # each chunk's routing is the reference's
    chunk = 16 if s % 16 == 0 else s
    for i in range(0, s, chunk):
        xc = x[:, i:i + chunk]
        _, ids, _, pos, keep = moe.route(p, torch.from_numpy(xc), cfg)
        want = _ref_routing(weights, xc, rcfg)
        for got, w, what in zip((ids, pos, keep), want,
                                ("ids", "pos", "keep")):
            assert np.array_equal(got.numpy(), w), f"{regime}: {what}"


@pytest.mark.parametrize("name", ARCHS)
def test_dropped_pairs_are_the_reference_s(name):
    """capacity_factor 0.5: pairs past an expert's capacity are dropped,
    and the kept (b, c, k) set is the reference's exactly."""
    cfg, rcfg, weights, x, p, (y, aux), (want_y, want_aux) = _both(
        name, 16, 5, capacity_factor=0.5)
    _, ids, _, pos, keep = moe.route(p, torch.from_numpy(x), cfg)
    want_ids, want_pos, want_keep = _ref_routing(weights, x, rcfg)
    assert np.array_equal(ids.numpy(), want_ids)
    assert np.array_equal(pos.numpy(), want_pos)
    assert np.array_equal(keep.numpy(), want_keep)
    dropped = int((~keep).sum())
    assert 0 < dropped < keep.numel()
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_uniform_router_ties_break_as_the_reference_s():
    """``tests/test_models.py::test_moe_aux_loss_balanced_router``: a zero
    router ties every expert; ``jax.lax.top_k`` takes the lower experts
    first, and so must the port, since the slots follow the choice order."""
    cfg, rcfg = _cfgs("granite-moe-1b-a400m")
    weights = _weights(rcfg, 6)
    weights["router"] = np.zeros_like(weights["router"])
    x = _x(cfg, 2, 32, 7)
    p = _port(cfg, weights)
    with torch.no_grad():
        y, aux = moe.moe_ffn(p, torch.from_numpy(x), cfg)
    want_y, want_aux = ref_moe_ffn(jax.tree.map(jnp.asarray, weights),
                                   jnp.asarray(x), rcfg)
    for i in (0, 16):
        xc = x[:, i:i + 16]
        _, ids, _, pos, keep = moe.route(p, torch.from_numpy(xc), cfg)
        want_ids, want_pos, want_keep = _ref_routing(weights, xc, rcfg)
        assert np.array_equal(ids.numpy(), want_ids)
        assert np.array_equal(ids[0, 0].numpy(), np.arange(cfg.top_k))
        assert np.array_equal(pos.numpy(), want_pos)
        assert np.array_equal(keep.numpy(), want_keep)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    assert y.shape == x.shape
    assert abs(float(aux) - 1.0) < 0.2
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_moe_ffn_bf16_matches_reference():
    cfg, rcfg, weights, x, p, (y, _), (want_y, _) = _both(
        "granite-moe-1b-a400m", 16, 8, param_dtype="bfloat16",
        compute_dtype="bfloat16")
    assert p.router.dtype == torch.float32 and p.w_up.dtype == torch.bfloat16
    assert y.dtype == torch.bfloat16
    got, want = y.float().numpy(), np.asarray(want_y.astype(jnp.float32))
    assert float(np.abs(got - want).max()) <= 0.02 * float(np.abs(want).max())


@pytest.mark.parametrize("act", ["silu_glu", "gelu_glu", "sq_relu"])
def test_experts_match_the_reference_for_each_activation(act):
    cfg, rcfg, weights, x, p, (y, aux), (want_y, want_aux) = _both(
        "granite-moe-1b-a400m", 16, 9, mlp_act=act)
    assert hasattr(p, "w_gate") == (act != "sq_relu")
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)


def test_init_draws_at_the_reference_scales():
    cfg = dataclasses.replace(configs.get_arch("granite-moe-1b-a400m",
                                               smoke=True),
                              d_model=256, d_ff=512, param_dtype="bfloat16")
    p = moe.MoE(cfg, "cpu")
    p.reset_parameters(torch.Generator().manual_seed(0))
    assert p.router.dtype == torch.float32
    assert p.w_up.shape == (cfg.n_experts, 256, 512)
    assert p.w_down.shape == (cfg.n_experts, 512, 256)
    for t, scale in ((p.router, 256 ** -0.5), (p.w_gate, 256 ** -0.5),
                     (p.w_up, 256 ** -0.5), (p.w_down, 512 ** -0.5)):
        t = t.detach().float()
        assert abs(float(t.std()) / scale - 1.0) < 0.03
        assert abs(float(t.mean())) < 0.03 * scale


def test_capacity_is_the_reference_s():
    for name in ARCHS:
        for changes in ({}, {"capacity_factor": 0.5},
                        {"capacity_factor": 8.0}):
            cfg, rcfg = _cfgs(name, **changes)
            full = dataclasses.replace(configs.get_arch(name), **changes)
            rfull = dataclasses.replace(ref_configs.get_arch(name), **changes)
            for c in (1, 16, 20, 512):
                assert moe._capacity(cfg, c) == ref._capacity(rcfg, c)
                assert moe._capacity(full, c) == ref._capacity(rfull, c)
