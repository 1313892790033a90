"""Parity of the port's RMSNorm (the plain version the CPU runs, which the
card's ``rmsnorm`` kernel is held against) with the reference's.

Tolerances: against the reference's oracle ``rmsnorm_ref`` and its Pallas
kernel in interpret mode, rtol 1e-6 / atol 1e-6 in fp32 (the same formula,
summed in another order) and at most 1 bf16 unit in the last place in bf16
(one rounding of fp32 values that may differ by an ulp). Against the
models' jnp ``repro.models.layers.rmsnorm``, equal to rtol 1e-6 in fp32;
in bf16 that function rounds the inverse RMS, x·inv and (1 + w) to bf16
before the last product, four roundings against one, and differs by at
most 3 bf16 ulps (measured: 3 over 40 draws; ROADMAP.md, queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rmsnorm_pallas
from repro.kernels.rmsnorm_ref import rmsnorm_ref
from repro.models.layers import rmsnorm as layers_rmsnorm
from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm_ops import rmsnorm_op
from repro_torch.kernels.rmsnorm_ref import bf16_ulp_distance, rmsnorm_plain
from repro_torch.models.layers import RMSNorm

LAYERS_BF16_ULPS = 3

SHAPES = [(5, 64), (3, 7, 100), (2, 3, 4, 128), (1, 100), (2, 2, 2, 64)]


def _inputs(shape, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale + 0.25).astype(np.float32)
    w = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, w


def _jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _torch(a, dtype):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _as_np(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_oracle_and_pallas(shape, dtype):
    x, w = _inputs(shape, sum(shape))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = rmsnorm_plain(_torch(_as_np(_jax(x, jdt)), tdt),
                        _torch(_as_np(_jax(w, jdt)), tdt))
    assert got.dtype == tdt and tuple(got.shape) == shape
    oracle = rmsnorm_ref(_jax(x, jdt), _jax(w, jdt))
    pallas = rmsnorm_pallas(_jax(x, jdt), _jax(w, jdt), block_rows=4,
                            interpret=True)
    for want in (oracle, pallas):
        want = torch.from_numpy(_as_np(want))
        if dtype == "float32":
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        else:
            assert int(bf16_ulp_distance(got, want).max()) <= 1


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_vs_the_models_jnp_rmsnorm(shape):
    x, w = _inputs(shape, 7 + sum(shape))
    got = rmsnorm_op(torch.from_numpy(x), torch.from_numpy(w))
    want = layers_rmsnorm(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    xb, wb = _jax(x, jnp.bfloat16), _jax(w, jnp.bfloat16)
    got = rmsnorm_op(_torch(_as_np(xb), torch.bfloat16),
                     _torch(_as_np(wb), torch.bfloat16))
    want = torch.from_numpy(_as_np(layers_rmsnorm(xb, wb)))
    assert int(bf16_ulp_distance(got, want).max()) <= LAYERS_BF16_ULPS


@pytest.mark.parametrize("seed", range(6))
def test_scale_invariance(seed):
    """rmsnorm(c·x) == rmsnorm(x) for c > 0, as tests/test_property.py
    holds the reference (rtol 2e-3 / atol 2e-3), and each equals the
    reference's oracle to 1e-5."""
    rng = np.random.default_rng(seed)
    rows, d = int(rng.integers(1, 10)), [8, 32, 128][seed % 3]
    c = float(rng.uniform(0.5, 4.0))
    x = (rng.standard_normal((rows, d)) + 0.1).astype(np.float32)
    w = (0.1 * rng.standard_normal(d)).astype(np.float32)
    a = rmsnorm_plain(torch.from_numpy(x), torch.from_numpy(w))
    b = rmsnorm_plain(torch.from_numpy(x * np.float32(c)),
                      torch.from_numpy(w))
    torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)
    want = np.asarray(rmsnorm_ref(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(a.numpy(), want, rtol=1e-5, atol=1e-5)


def test_op_on_cpu_runs_the_plain_version_and_checks_its_operands():
    x, w = _inputs((4, 3, 64), 3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    _build.reset_launches()
    got = rmsnorm_op(xt, wt)
    norm = RMSNorm(64, torch.float32, "cpu")
    with torch.no_grad():
        norm.w.copy_(wt)
    assert torch.equal(got, rmsnorm_plain(xt, wt))
    assert torch.equal(norm(xt), got)
    assert _build.launches["rmsnorm"] == 0
    # mixed dtypes: bf16 activations with an fp32 weight keep x's dtype
    assert rmsnorm_op(xt.bfloat16(), wt).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="shape"):
        rmsnorm_op(xt, wt[:10])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rmsnorm_op(xt.double(), wt)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rmsnorm_op(xt, wt.half())


def test_ulp_distance_counts_bf16_steps():
    one = torch.tensor([1.0], dtype=torch.bfloat16)
    nxt = torch.nextafter(one.float(), torch.tensor([2.0])).bfloat16()
    step = torch.tensor([1.0 + 2 ** -7], dtype=torch.bfloat16)
    assert int(bf16_ulp_distance(one, one)) == 0
    assert int(bf16_ulp_distance(one, step)) == 1
    assert int(bf16_ulp_distance(nxt, one)) == 0      # rounds back to 1.0
    assert int(bf16_ulp_distance(torch.tensor([0.0]),
                                 torch.tensor([-0.0]))) == 0
    small = torch.tensor([2 ** -133], dtype=torch.bfloat16)   # least subnormal
    assert int(bf16_ulp_distance(small, -small)) == 2
