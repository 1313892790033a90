"""The port's AdamW (``repro_torch.optim``) against ``repro.optim.adamw``.

The three cases of ``tests/test_runtime.py``'s optimizer section, through
the port, and ``lr_schedule`` and ``adamw_update`` against the reference on
the same inputs: a tree of 1-D and 2-D leaves (the decay rule's two kinds),
fp32 and bf16 parameters, fp32 and bf16 moments, three steps from a state
with non-zero moments, one gradient large enough to clip.

Tolerances: the learning rate at rtol 1e-6 (one fp32 ``cos`` apart); the
updated parameters and moments at rtol 1e-5 / atol 1e-5·max(scale, 1) in
fp32 (the same elementwise formulas, the global norm summed in another
order) and within 1 bf16 unit in the last place where the leaf is bf16
(one rounding of fp32 values that may differ in their last bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_update as ref_adamw_update
from repro.optim.adamw import lr_schedule as ref_lr_schedule
from repro_torch.kernels.rmsnorm_ref import bf16_ulp_distance
from repro_torch.optim import (AdamWConfig, adamw_update, init_opt_state,
                               lr_schedule)


def test_lr_schedule_shape():
    opt = AdamWConfig(peak_lr=1e-2, warmup_steps=10, decay_steps=100,
                      min_lr_ratio=0.1)
    lrs = [float(lr_schedule(opt, torch.tensor(s))) for s in
           (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0
    assert abs(lrs[2] - 1e-2) < 1e-9          # peak at warmup end
    assert lrs[3] < lrs[2]
    assert abs(lrs[4] - 1e-3) < 1e-6          # floor = ratio · peak


def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = AdamWConfig(peak_lr=0.1, warmup_steps=1, decay_steps=400,
                      weight_decay=0.0, clip_norm=10.0)
    state = init_opt_state(params)
    target = torch.tensor([1.0, 2.0])

    def loss(p):
        return torch.sum((p["w"] - target) ** 2)

    for _ in range(300):
        w = params["w"].clone().requires_grad_()
        (g,) = torch.autograd.grad(loss({"w": w}), (w,))
        params, state, _ = adamw_update({"w": g}, state, params, opt)
    assert float(loss(params)) < 1e-2


def test_adamw_grad_clipping_bounds_update():
    params = {"w": torch.zeros(3)}
    opt = AdamWConfig(peak_lr=1.0, warmup_steps=0, decay_steps=10,
                      clip_norm=1.0, weight_decay=0.0)
    state = init_opt_state(params)
    g = {"w": torch.tensor([1e6, 0.0, 0.0])}
    _, _, metrics = adamw_update(g, state, params, opt)
    assert float(metrics["grad_norm"]) > 1e5   # reported raw norm


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
def test_lr_schedule_matches_reference(step):
    kw = dict(peak_lr=3e-4, warmup_steps=10, decay_steps=100,
              min_lr_ratio=0.1)
    got = lr_schedule(AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32))
    want = ref_lr_schedule(RefAdamWConfig(**kw), jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _tree(rng, scale):
    return {"w2": (scale * rng.standard_normal((6, 5))).astype(np.float32),
            "w1": (scale * rng.standard_normal(7)).astype(np.float32),
            "b3": (scale * rng.standard_normal((2, 3, 4))).astype(np.float32)}


def _hold(got: torch.Tensor, want, what):
    want = torch.from_numpy(np.array(jnp.asarray(want).astype(jnp.float32)))
    if got.dtype == torch.bfloat16:
        assert int(bf16_ulp_distance(got, want).max()) <= 1, what
        return
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * max(scale, 1.0), msg=what)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [False, True])
def test_adamw_update_matches_reference(param_dtype, moment_dtype, clip):
    rng = np.random.default_rng(7)
    kw = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=20, weight_decay=0.1,
              clip_norm=1.0)
    p_np = _tree(rng, 1.0)
    m_np = _tree(rng, 1e-2)
    v_np = {k: (v * v + 1e-6) for k, v in _tree(rng, 1e-2).items()}
    pdt, mdt = getattr(torch, param_dtype), getattr(torch, moment_dtype)
    jpdt, jmdt = getattr(jnp, param_dtype), getattr(jnp, moment_dtype)

    def port(t, dt):
        return {k: torch.from_numpy(np.array(jnp.asarray(v).astype(
            getattr(jnp, str(dt).removeprefix("torch."))).astype(
            jnp.float32))).to(dt) for k, v in t.items()}
    params, state = port(p_np, pdt), {"m": port(m_np, mdt),
                                      "v": port(v_np, mdt),
                                      "step": torch.tensor(3, dtype=torch.int32)}
    rparams = {k: jnp.asarray(v).astype(jpdt) for k, v in p_np.items()}
    rstate = {"m": {k: jnp.asarray(v).astype(jmdt) for k, v in m_np.items()},
              "v": {k: jnp.asarray(v).astype(jmdt) for k, v in v_np.items()},
              "step": jnp.asarray(3, jnp.int32)}
    for step in range(3):
        g_np = _tree(rng, 10.0 if clip else 0.01)
        _, state, metrics = adamw_update(
            {k: torch.from_numpy(v.copy()) for k, v in g_np.items()}, state,
            params, AdamWConfig(**kw))
        rparams, rstate, rmetrics = ref_adamw_update(
            {k: jnp.asarray(v) for k, v in g_np.items()}, rstate, rparams,
            RefAdamWConfig(**kw))
        assert (float(metrics["grad_norm"]) > 1.0) == clip
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(rmetrics[key]), rtol=1e-5,
                                       err_msg=f"step {step} {key}")
        for k in p_np:
            assert params[k].dtype == pdt and state["m"][k].dtype == mdt
            _hold(params[k], rparams[k], f"step {step} param {k}")
            _hold(state["m"][k], rstate["m"][k], f"step {step} m {k}")
            _hold(state["v"][k], rstate["v"][k], f"step {step} v {k}")
    assert int(state["step"]) == int(rstate["step"]) == 6


def test_decay_skips_one_dimensional_leaves_and_names_are_checked():
    params = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    opt = AdamWConfig(peak_lr=1.0, warmup_steps=0, weight_decay=0.5)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    adamw_update(zeros, init_opt_state(params), params, opt)
    assert torch.equal(params["b"], torch.ones(2))        # no decay
    assert bool((params["w"] < 1).all())                   # decayed
    adamw_update(dict(zeros), init_opt_state(params), params, opt,
                 decayed={"b"})
    assert bool((params["b"] < 1).all())
    with pytest.raises(KeyError, match="different leaves"):
        adamw_update({"w": zeros["w"]}, init_opt_state(params), params, opt)
