"""Parity of the port's SSD mixer (``repro_torch.models.ssd``) with
``repro.models.ssd`` on the same numpy weights and inputs, in fp32.

The weights are the reference's ``init_ssd`` at mamba2-1.3b's smoke widths
(d = 64, 8 heads of 16, state 16, chunk 8), its zero norm weight drawn
non-zero so that it acts; the reference runs under ``jax.jit``. Tolerance:
rtol 1e-5 / atol 1e-5 on outputs and caches (the same formulas; the
intra-chunk contraction and the chunk states sum in another order).

The port masks the intra-chunk decay's exponent before the ``exp`` where
the reference zeroes ``exp``'s output after (ROADMAP.md, queue 3). At chunk
256 the exponent above the diagonal passes 88.7 and the reference's
``exp`` overflows: its gradient is NaN there, its forward finite. The
port's forward equals it to rtol 1e-5 / atol 1e-5·max(scale, 1) (the
chunk's 256-term sums: against an fp64 evaluation of the same formulas the
port is 2.4e-5 off and the reference 1.6e-5, at a scale of 4.4) and its
gradients are finite.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro import configs as ref_configs
from repro.models import ssd as ref
from repro_torch import configs
from repro_torch.models import ssd

TOL = {"rtol": 1e-5, "atol": 1e-5}
NAME = "mamba2-1.3b"

ref_forward = jax.jit(ref.ssd_forward, static_argnums=(2,))
ref_decode = jax.jit(ref.ssd_decode, static_argnums=(3,))


def _cfgs(**changes):
    return (dataclasses.replace(configs.get_arch(NAME, smoke=True),
                                **changes),
            dataclasses.replace(ref_configs.get_arch(NAME, smoke=True),
                                **changes))


def _both(cfg, rcfg, seed):
    """(port module, reference params) holding the same weights."""
    w = {k: np.asarray(v) for k, v in
         ref.init_ssd(jax.random.PRNGKey(seed), rcfg).items()}
    w["norm_w"] = (0.1 * np.random.default_rng(seed).standard_normal(
        w["norm_w"].shape)).astype(np.float32)
    p = ssd.SSD(cfg, "cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in w.items()})
    return p, {k: jnp.asarray(v) for k, v in w.items()}


def _close(got, want, scaled=False):
    """Within rtol 1e-5 / atol 1e-5 (``scaled``: atol 1e-5·max(scale, 1))."""
    want = np.asarray(want)
    atol = TOL["atol"] * (max(float(np.abs(want).max()), 1.0) if scaled
                          else 1.0)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL["rtol"],
                               atol=atol)


def _x(cfg, s, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (2, s, cfg.d_model))).astype(np.float32)


@pytest.mark.parametrize("s", [24, 20, 3],
                         ids=["three-chunks", "one-chunk-of-20", "short"])
def test_ssd_forward_matches_reference(s):
    """Three chunks of 8 (s = 24), and the ``q = s`` fallback (s % 8)."""
    cfg, rcfg = _cfgs()
    p, rp = _both(cfg, rcfg, 1)
    x = _x(cfg, s, s)
    out, cache = ssd.ssd_forward(p, torch.from_numpy(x), cfg)
    want, wcache = ref_forward(rp, jnp.asarray(x), rcfg)
    assert out.shape == x.shape
    _close(out, want)
    _close(cache.conv, wcache["conv"])
    _close(cache.h, wcache["h"])


def test_ssd_forward_continues_from_a_cache():
    """A second prefill from the first's cache: the carried state enters
    the inter-chunk recurrence and the conv, as there."""
    cfg, rcfg = _cfgs()
    p, rp = _both(cfg, rcfg, 2)
    x = _x(cfg, 32, 2)
    _, cache = ssd.ssd_forward(p, torch.from_numpy(x[:, :16]), cfg)
    _, wcache = ref_forward(rp, jnp.asarray(x[:, :16]), rcfg)
    out, cache = ssd.ssd_forward(p, torch.from_numpy(x[:, 16:]), cfg, cache)
    want, wcache = ref_forward(rp, jnp.asarray(x[:, 16:]), rcfg, wcache)
    _close(out, want)
    _close(cache.h, wcache["h"])


def test_ssd_decode_matches_reference():
    cfg, rcfg = _cfgs()
    p, rp = _both(cfg, rcfg, 3)
    x = _x(cfg, 20, 3)
    _, cache = ssd.ssd_forward(p, torch.from_numpy(x[:, :16]), cfg)
    _, wcache = ref_forward(rp, jnp.asarray(x[:, :16]), rcfg)
    for t in range(16, 20):
        out, cache = ssd.ssd_decode(p, torch.from_numpy(x[:, t:t + 1]),
                                    cache, cfg)
        want, wcache = ref_decode(rp, jnp.asarray(x[:, t:t + 1]), wcache,
                                  rcfg)
        _close(out, want)
        _close(cache.conv, wcache["conv"])
        _close(cache.h, wcache["h"])
    empty = ssd.init_ssd_cache(cfg, 2, "cpu")
    want = ref.init_ssd_cache(rcfg, 2)
    assert tuple(empty.conv.shape) == want["conv"].shape
    assert tuple(empty.h.shape) == want["h"].shape
    assert empty.h.dtype == torch.float32


def test_decay_that_overflows_in_the_reference_form():
    """Chunk 256 at the smoke widths, one chunk of standard-normal input:
    above the diagonal ``cs_i − cs_j`` passes 88.7, the reference's
    ``exp`` overflows and its gradient is NaN; the port's forward is the
    reference's and its gradients (x and every parameter) are finite."""
    cfg, rcfg = _cfgs(ssm_chunk=256)
    p, rp = _both(cfg, rcfg, 4)
    x = np.random.default_rng(4).standard_normal(
        (1, 256, cfg.d_model)).astype(np.float32)
    # the reference's own exponent: cs_0 − cs_255 = −Σ dA over the chunk
    _, _, _, _, dt, _ = ref._conv_split(rp, jnp.asarray(x), rcfg)
    span = -np.asarray(jnp.sum(dt * -jnp.exp(rp["a_log"]), axis=1))[0]
    assert float(span.max()) > 88.8, span

    want, _ = ref_forward(rp, jnp.asarray(x), rcfg)
    ref_grad = jax.jit(jax.grad(lambda xx: jnp.sum(
        ref.ssd_forward(rp, xx, rcfg)[0])))(jnp.asarray(x))
    assert np.isnan(np.asarray(ref_grad)).any()

    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = ssd.ssd_forward(p, xt, cfg)
    _close(out, want, scaled=True)
    out.sum().backward()
    assert bool(torch.isfinite(xt.grad).all())
    for name, t in p.named_parameters():
        assert t.grad is not None and bool(torch.isfinite(t.grad).all()), \
            name
    assert bool(p.norm_w.grad.abs().sum() > 0)


def test_gated_norm_runs_through_the_rmsnorm_function():
    """The gated norm is the port's ``rmsnorm_op``: under autograd its
    gradient reaches ``norm_w`` and equals the one torch derives from the
    norm's formula."""
    cfg, _ = _cfgs()
    p = ssd.SSD(cfg, "cpu")
    p.reset_parameters(torch.Generator().manual_seed(5))
    with torch.no_grad():
        p.norm_w.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(6))
    x = torch.from_numpy(_x(cfg, 16, 6))
    out, _ = ssd.ssd_forward(p, x, cfg)
    (g,) = torch.autograd.grad(out.square().sum(), p.norm_w)
    # the same forward with the norm written out in torch ops
    orig = ssd.rmsnorm_op
    try:
        ssd.rmsnorm_op = lambda y, w: (
            y * torch.rsqrt(y.float().square().mean(-1, keepdim=True)
                            + 1e-6).to(y.dtype) * (1 + w))
        out, _ = ssd.ssd_forward(p, x, cfg)
        (want,) = torch.autograd.grad(out.square().sum(), p.norm_w)
    finally:
        ssd.rmsnorm_op = orig
    assert bool(g.abs().sum() > 0)
    torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-5)


def test_init_draws_at_the_reference_ranges():
    cfg, _ = _cfgs()
    p = ssd.SSD(cfg, "cpu")
    p.reset_parameters(torch.Generator().manual_seed(0))
    dt = torch.nn.functional.softplus(p.dt_bias.detach())
    assert 1e-3 - 1e-7 <= float(dt.min()) and float(dt.max()) <= 0.1 + 1e-7
    a = torch.exp(p.a_log.detach())
    assert 1.0 - 1e-6 <= float(a.min()) and float(a.max()) <= 16.0 + 1e-5
    assert torch.equal(p.d_skip.detach(), torch.ones(cfg.ssm_nheads))
    assert not bool(p.norm_w.detach().any())
    for t in (p.dt_bias, p.a_log, p.d_skip):
        assert t.dtype == torch.float32
