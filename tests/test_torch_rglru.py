"""Parity of the port's RG-LRU block (``repro_torch.models.rglru``) with
``repro.models.rglru`` on the same numpy weights and inputs.

The weights are the reference's ``init_rec`` at recurrentgemma-9b's smoke
widths (d = r = 64), its zero biases drawn non-zero so that they act; the
reference runs under ``jax.jit``. Tolerances: rtol 1e-5 / atol 1e-5 in
fp32. The conv sums the same products in the same order; the scan sums in
another: the port's Hillis–Steele doubling against the reference's
odd/even ``associative_scan`` tree (ROADMAP.md, queue 3), each step an
fp32 product and sum. In bf16 the conv is bitwise the reference's (each
product and partial sum rounded to bf16 in the same order), and the block's
output lies within 0.02·max|out| of the reference's with correlation at
least 0.999 (its bf16 products round at other places: measured 0.0093 of the
scale, correlation 0.99999).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro import configs as ref_configs
from repro.models import rglru as ref
from repro_torch import configs
from repro_torch.models import rglru

TOL = {"rtol": 1e-5, "atol": 1e-5}
NAME = "recurrentgemma-9b"

ref_scan = jax.jit(ref.rglru_scan, static_argnums=(2,))
ref_forward = jax.jit(ref.rec_forward, static_argnums=(2,))
ref_decode = jax.jit(ref.rec_decode, static_argnums=(3,))


def _cfgs(**changes):
    return (dataclasses.replace(configs.get_arch(NAME, smoke=True),
                                **changes),
            dataclasses.replace(ref_configs.get_arch(NAME, smoke=True),
                                **changes))


def _weights(rcfg, seed):
    """The reference's params as numpy (bf16 as float32, exactly), the
    biases non-zero."""
    p = ref.init_rec(jax.random.PRNGKey(seed), rcfg)
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v.astype(jnp.float32)) for k, v in p.items()}
    for key in ("b_a", "b_x"):
        p[key] = (0.3 * rng.standard_normal(p[key].shape)).astype(np.float32)
    return p


def _both(cfg, rcfg, seed):
    """(port module, reference params) holding the same weights."""
    w = _weights(rcfg, seed)
    p = rglru.Rec(cfg, "cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v)).to(
        torch.float32 if k == "lambda" else cfg.dtype())
        for k, v in w.items()})
    rp = {k: jnp.asarray(v).astype(jnp.float32 if k == "lambda"
                                   else rcfg.dtype())
          for k, v in w.items()}
    return p, rp


def _np(t):
    return np.asarray(jnp.asarray(t).astype(jnp.float32)) if not \
        isinstance(t, torch.Tensor) else t.detach().float().numpy()


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(with_state, dtype):
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out, new = rglru.causal_conv(
        torch.from_numpy(u).to(tdt), torch.from_numpy(w).to(tdt),
        torch.from_numpy(st).to(tdt) if with_state else None)
    wout, wnew = ref.causal_conv(jnp.asarray(u).astype(jdt),
                                 jnp.asarray(w).astype(jdt),
                                 jnp.asarray(st).astype(jdt)
                                 if with_state else None)
    assert out.dtype == new.dtype == tdt
    if dtype == "bfloat16":     # the same roundings in the same order
        assert np.array_equal(_np(out), _np(wout))
    else:
        _close(out, wout)
    assert np.array_equal(_np(new), _np(wnew))
    assert new.data_ptr() != out.data_ptr() and new.is_contiguous()


@pytest.mark.parametrize("s", [9, 512, 1024, 1536])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference(s, with_h0):
    """One scan (s <= 512) and chunks of 512 (1024, 1536), with and without
    a carried state."""
    cfg, rcfg = _cfgs()
    p, rp = _both(cfg, rcfg, 2)
    rng = np.random.default_rng(s)
    u = rng.standard_normal((2, s, cfg.lru_width_actual)).astype(np.float32)
    h0 = rng.standard_normal((2, cfg.lru_width_actual)).astype(np.float32)
    h, last = rglru.rglru_scan(p, torch.from_numpy(u), cfg,
                               torch.from_numpy(h0) if with_h0 else None)
    wh, wlast = ref_scan(rp, jnp.asarray(u), rcfg,
                         jnp.asarray(h0) if with_h0 else None)
    assert last.dtype == torch.float32 and h.shape == u.shape
    _close(h, wh)
    _close(last, wlast)


def test_scan_is_the_sequential_recurrence():
    """The doubling scan against a plain loop over time in fp64."""
    gen = torch.Generator().manual_seed(3)
    a = torch.rand((2, 37, 5), generator=gen, dtype=torch.float64)
    b = torch.randn((2, 37, 5), generator=gen, dtype=torch.float64)
    h, want = torch.zeros((2, 5), dtype=torch.float64), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(rglru._scan(a, b), torch.stack(want, dim=1),
                               rtol=1e-12, atol=1e-12)


def test_rglru_step_matches_reference():
    cfg, rcfg = _cfgs()
    p, rp = _both(cfg, rcfg, 4)
    rng = np.random.default_rng(4)
    u = rng.standard_normal((3, 1, cfg.lru_width_actual)).astype(np.float32)
    h = rng.standard_normal((3, cfg.lru_width_actual)).astype(np.float32)
    out, new = rglru.rglru_step(p, torch.from_numpy(u), torch.from_numpy(h),
                                cfg)
    wout, wnew = ref.rglru_step(rp, jnp.asarray(u), jnp.asarray(h), rcfg)
    _close(out, wout)
    _close(new, wnew)


@pytest.mark.parametrize("s", [11, 1024])
def test_rec_forward_and_decode_match_reference(s):
    """The block's prefill (its cache included) and four decode steps from
    it, against the reference's."""
    cfg, rcfg = _cfgs()
    p, rp = _both(cfg, rcfg, 5)
    rng = np.random.default_rng(5)
    x = (0.5 * rng.standard_normal((2, s + 4, cfg.d_model))).astype(
        np.float32)
    out, (conv, h) = rglru.rec_forward(p, torch.from_numpy(x[:, :s]), cfg)
    wout, (wconv, wh) = ref_forward(rp, jnp.asarray(x[:, :s]), rcfg)
    _close(out, wout)
    _close(conv, wconv)
    _close(h, wh)
    cache = rglru.RecCache(conv=conv, h=h)
    wcache = {"conv": wconv, "h": wh}
    for t in range(s, s + 4):
        step, cache = rglru.rec_decode(p, torch.from_numpy(x[:, t:t + 1]),
                                       cache, cfg)
        wstep, wcache = ref_decode(rp, jnp.asarray(x[:, t:t + 1]), wcache,
                                   rcfg)
        _close(step, wstep)
        _close(cache.conv, wcache["conv"])
        _close(cache.h, wcache["h"])
    empty = rglru.init_rec_cache(cfg, 2, "cpu")
    want = ref.init_rec_cache(rcfg, 2)
    assert empty.h.dtype == torch.float32 and empty.conv.dtype == cfg.dtype()
    assert tuple(empty.conv.shape) == want["conv"].shape
    assert tuple(empty.h.shape) == want["h"].shape


def test_rec_forward_bf16_is_within_its_tolerance():
    cfg, rcfg = _cfgs(param_dtype="bfloat16", compute_dtype="bfloat16")
    p, rp = _both(cfg, rcfg, 6)
    x = np.random.default_rng(6).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    out, (_, h) = rglru.rec_forward(
        p, torch.from_numpy(x).to(torch.bfloat16), cfg)
    wout, (_, wh) = ref_forward(rp, jnp.asarray(x).astype(jnp.bfloat16),
                                rcfg)
    assert out.dtype == torch.bfloat16 and getattr(p, "lambda").dtype == \
        torch.float32 and h.dtype == torch.float32
    got, want = _np(out), _np(wout)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 0.02 * scale
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] >= 0.999


def test_init_draws_at_the_reference_scales():
    """Λ puts a = exp(−8 softplus(Λ)) in [0.9, 0.999]; the matrices at
    their fan-in scales; the biases zero."""
    cfg = dataclasses.replace(configs.get_arch(NAME, smoke=True),
                              d_model=256, lru_width=512)
    p = rglru.Rec(cfg, "cpu")
    p.reset_parameters(torch.Generator().manual_seed(0))
    a = torch.exp(-8.0 * rglru.softplus(getattr(p, "lambda").detach()))
    assert 0.9 - 1e-6 <= float(a.min()) and float(a.max()) <= 0.999 + 1e-6
    for t, scale in ((p.w_gate_branch, 256 ** -0.5), (p.w_a, 512 ** -0.5),
                     (p.w_out, 512 ** -0.5), (p.conv_w, 4 ** -0.5)):
        assert abs(float(t.detach().std()) / scale - 1.0) < 0.05
    assert not bool(p.b_a.any()) and not bool(p.b_x.any())
