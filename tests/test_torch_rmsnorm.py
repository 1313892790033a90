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

The backward (``rmsnorm_backward_plain``, the formula the card's
``rmsnorm_bwd`` kernel computes) against ``torch.autograd`` of
``rmsnorm_plain`` and against ``jax.grad`` of the reference's
``rmsnorm_ref``, in fp32 at rtol 1e-5 / atol 1e-5·max(scale, 1): the same
derivative, summed in another order (its row sums in fp64). Through
``rmsnorm_op`` on the CPU (the ``RMSNormFunction`` route) the gradients are
the plain backward's, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.kernels import rmsnorm_pallas
from repro.kernels.rmsnorm_ref import rmsnorm_ref
from repro.models.layers import rmsnorm as layers_rmsnorm
from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm_ops import rmsnorm_op
from repro_torch.kernels.rmsnorm import (BWD_MAX_BLOCKS, BWD_MIN_ROWS,
                                         bwd_grid)
from repro_torch.kernels.rmsnorm_ref import (bf16_ulp_distance,
                                             rms_inverse_plain,
                                             rmsnorm_backward_plain,
                                             rmsnorm_plain)
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


def _grad_inputs(shape, seed):
    x, w = _inputs(shape, seed)
    dy = np.random.default_rng(seed + 1).standard_normal(shape).astype(
        np.float32)
    return x, w, dy


def _close(got, want):
    want = torch.as_tensor(np.array(want))
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * max(scale, 1.0))


@pytest.mark.parametrize("shape", SHAPES + [(64, 3072), (3, 4, 130)], ids=str)
def test_plain_backward_matches_autograd_and_jax_grad(shape):
    x, w, dy = _grad_inputs(shape, 11 + sum(shape))
    dx, dw = rmsnorm_backward_plain(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(dy))
    assert dx.shape == x.shape and dw.shape == w.shape
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    ax, aw = torch.autograd.grad(rmsnorm_plain(xt, wt), (xt, wt),
                                 torch.from_numpy(dy))
    _close(dx, ax)
    _close(dw, aw)
    _, vjp = jax.vjp(rmsnorm_ref, jnp.asarray(x), jnp.asarray(w))
    jx, jw = vjp(jnp.asarray(dy))
    _close(dx, jx)
    _close(dw, jw)
    # the forward's inverse RMS, passed in, gives the same gradients
    inv = rms_inverse_plain(torch.from_numpy(x))
    again = rmsnorm_backward_plain(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(dy), inv=inv.flatten())
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)


@pytest.mark.parametrize("dtype,w_dtype", [("float32", "float32"),
                                           ("bfloat16", "bfloat16"),
                                           ("bfloat16", "float32")])
def test_function_cpu_route_is_the_plain_backward(dtype, w_dtype):
    """Under autograd, ``rmsnorm_op`` on the CPU runs the plain forward and
    the plain backward: no launch, dx in x's dtype and dw in w's."""
    x, w, dy = _grad_inputs((2, 3, 4, 128), 5)
    tdt, wdt = getattr(torch, dtype), getattr(torch, w_dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).to(wdt).requires_grad_()
    dyt = torch.from_numpy(dy).to(tdt)
    _build.reset_launches()
    out = rmsnorm_op(xt, wt)
    assert out.grad_fn is not None and out.dtype == tdt
    assert torch.equal(out, rmsnorm_plain(xt.detach(), wt.detach()))
    gx, gw = torch.autograd.grad(out, (xt, wt), dyt)
    want = rmsnorm_backward_plain(xt.detach(), wt.detach(), dyt)
    assert gx.dtype == tdt and gw.dtype == wdt
    assert torch.equal(gx, want[0]) and torch.equal(gw, want[1])
    # only x, or only w, asks for a gradient
    (only_w,) = torch.autograd.grad(rmsnorm_op(xt.detach(), wt), (wt,), dyt)
    assert torch.equal(only_w, want[1])
    norm = RMSNorm(128, wdt, "cpu")
    (gn,) = torch.autograd.grad(norm(xt.detach()), (norm.w,), dyt)
    assert gn.shape == (128,)
    assert set(_build.launches.values()) == {0}


@pytest.mark.parametrize("rows,d", [(1, 128), (24576, 128), (1024, 3072),
                                    (2048, 4096), (5, 3070), (63, 256),
                                    (100000, 64)])
def test_backward_grid_depends_on_the_shape_alone(rows, d):
    """One cooperative launch: at most BWD_MAX_BLOCKS blocks, the 114 SMs
    of the PCIe H100, so the grid is resident on either card; every block
    takes at least its route's least rows and every row has one block."""
    blocks, per_block = bwd_grid(rows, d)
    route = "warp" if d <= 256 else "block"
    assert BWD_MAX_BLOCKS == 114
    assert 1 <= blocks <= BWD_MAX_BLOCKS
    assert (blocks - 1) * per_block < rows <= blocks * per_block
    assert per_block >= min(BWD_MIN_ROWS[route], rows)
    assert bwd_grid(rows, d) == (blocks, per_block)


def test_backward_wrapper_refuses_what_its_kernel_does_not_take():
    """The checks run before any build or launch, so they hold here."""
    from repro_torch.kernels.rmsnorm import MAX_BWD_D
    from repro_torch.kernels.rmsnorm import rmsnorm_backward as rmsnorm_bwd

    x = torch.zeros(4, 8)
    w, inv, dy = torch.zeros(8), torch.zeros(4), torch.zeros(4, 8)
    with pytest.raises(TypeError, match="dy"):
        rmsnorm_bwd(x, w, inv, dy.bfloat16())
    with pytest.raises(ValueError, match="inv"):
        rmsnorm_bwd(x, w, torch.zeros(5), dy)
    with pytest.raises(TypeError, match="inv"):
        rmsnorm_bwd(x, w, inv.double(), dy)
    with pytest.raises(ValueError, match="w"):
        rmsnorm_bwd(x, torch.zeros(7), inv, dy)
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm_bwd(torch.zeros(8, 4).T, w, inv, dy)
    with pytest.raises(ValueError, match="d <="):
        rmsnorm_bwd(torch.zeros(1, MAX_BWD_D + 1), torch.zeros(MAX_BWD_D + 1),
                    torch.zeros(1), torch.zeros(1, MAX_BWD_D + 1))
    with pytest.raises(TypeError, match="w must be float32 or bfloat16"):
        rmsnorm_bwd(x, w.double(), inv, dy)
