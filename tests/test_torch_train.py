"""The LM training path as a whole: ``repro_torch.runtime.train`` against
``repro.runtime.train.build_train_step_fn`` from the same state.

For each dense smoke config the reference's ``init_train_state`` draws the
weights (its zero-initialised norm weights and QKV biases then drawn
non-zero with numpy, so each acts), and the optimizer state is a resumed
run's: moments drawn with numpy at step 10, so that the converted m and v
act too. ``convert.lm_params_from_reference`` and
``opt_state_from_reference`` carry them over, and both packages take three
steps on the reference pipeline's batches
(``repro.data.pipeline.TokenPipeline``), under each remat mode and with one
and two microbatches.

Tolerances: the loss, ``grad_norm`` and ``lr`` of every step at rtol 1e-5;
after three steps every parameter and both moments at rtol 1e-5 / atol
1e-5·max(scale, 1), the kernels' own tolerance: the same formulas in fp32,
products summed in another order. The learning rate (~1e-3) makes each step
move the parameters by ~1e-3, a hundred times the tolerance, so a wrong
update cannot pass. The moments are not zero because a first step from zero
moments is ill-conditioned in exactly the parameters this test holds: there
u = g / (|g| + eps), whose slope eps / (|g| + eps)² reaches 1 / (4·eps) =
2.5e7 at |g| = eps = 1e-8, so a gradient that cancels to ~1e-8 turns a
rounding-level difference into a visible update (measured: qwen3-8b-smoke,
two microbatches, one w_up element of 8192 with |g| = 4.5e-8 moved 2.3e-5
apart after three steps). ``test_arch_smoke_forward_and_train_step`` and
``tests/test_torch_launch_train.py`` step from zero moments.

The four archs of the MoE and vision slice run the same check at one
(microbatches, remat) pair each, chosen so that each mode is still met:
the whole matrix over seven archs would cost about a minute more of the
suite, and the pairs change what is kept, not what is computed (the dense
smokes above run all six). nemotron's smoke takes its published bf16
moments (``opt_dtype``; these to within one bf16 ulp of the value a step
beside the fp32 atol, with at most 1 element in 1000 apart: each step
rounds the fp32 moment to bf16 once, a rounding-level difference may land
it one ulp apart, and an earlier step's ulp carries on; measured at most 2
ulps, in at most 9 of 16384 elements a leaf), granite-moe and grok their MoE aux loss (through
``_AUX_WEIGHT``) and fp32 routers, phi-3-vision its patches
(``batch["patches"]``, the same numpy normals on both sides) and its loss
on the text positions. The MoE smokes train at their own capacity: the
dropped pairs are the reference's (``tests/test_torch_moe.py``). The SSD,
RG-LRU and enc-dec slice's archs run one pair each too, with one
microbatch (the reference's accumulation scan costs its jit 10 s more a
case; ``chip_smoke.py`` phase 8b trains the three at two microbatches,
card against CPU): mamba2-1.3b (its two SSD layers in chunks of 8, the
fp32 Δ bias, A and skip decayed as the reference decays its stacked
leaves), recurrentgemma-9b (a (rec, rec, local) period under remat and a
remainder rec layer, whose 1-D leaves, fp32 Λ included, are not decayed)
and seamless-m4t-medium (its frames as ``batch["frames"]``, the same
numpy normals on both sides; every block checkpointed whatever ``remat``
says, as there).

``lm_loss`` against the reference's at rtol 1e-5 on the chunked route
(S = 2048) and the one-block route (S = 1000, S = 1024).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro import configs as ref_configs
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.runtime import loss as ref_loss
from repro.runtime import train as ref_train
from repro_torch import configs, models
from repro_torch.convert import (lm_params_from_reference,
                                 opt_state_from_reference)
from repro_torch.kernels import _build
from repro_torch.models.layers import Embedding
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import loss as port_loss
from repro_torch.runtime.train import (abstract_train_state,
                                       build_train_step_fn, decayed_leaves,
                                       init_train_state, make_train_step)

ARCHS = ("llama3.2-3b", "qwen3-8b", "qwen1.5-4b")
#: the MoE and vision slice's archs: (arch, microbatches, remat, changes)
NEW_ARCHS = (("nemotron-4-340b", 2, "full", {"opt_dtype": "bfloat16"}),
             ("granite-moe-1b-a400m", 2, "dots", {}),
             ("grok-1-314b", 1, "none", {}),
             ("phi-3-vision-4.2b", 2, "full", {}),
             ("mamba2-1.3b", 1, "dots", {}),
             ("recurrentgemma-9b", 1, "full", {}),
             ("seamless-m4t-medium", 1, "none", {}))
STEPS, BATCH, SEQ = 3, 4, 16
OPT = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=100)
START_STEP = 10       # the resumed optimizer state's step


def _cfgs(name, **changes):
    return (dataclasses.replace(configs.get_arch(name, smoke=True), **changes),
            dataclasses.replace(ref_configs.get_arch(name, smoke=True),
                                **changes))


def _reference_state(rcfg, seed):
    """The reference's params, every zero-initialised leaf drawn non-zero,
    and a resumed optimizer state of the reference's layout: m ~ 1e-3·N(0,
    1) and v = (2e-3·N(0, 1))² + 1e-6 at step START_STEP."""
    params, opt_state = ref_train.init_train_state(jax.random.PRNGKey(seed),
                                                   rcfg)
    rng = np.random.default_rng(seed)

    def nonzero(path, leaf):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("'w'", "'b'", "'bq'", "'bk'", "'bv'",
                                   "q_norm", "k_norm", "'norm_w'", "'b_a'",
                                   "'b_x'")):
            noise = 0.1 * rng.standard_normal(leaf.shape).astype(np.float32)
            return jnp.asarray(noise).astype(leaf.dtype)
        return leaf

    def drawn(scale, square):
        def one(leaf):
            z = scale * rng.standard_normal(leaf.shape)
            z = z * z + 1e-6 if square else z
            return jnp.asarray(z.astype(np.float32)).astype(leaf.dtype)
        return one
    opt_state = {"m": jax.tree.map(drawn(1e-3, False), opt_state["m"]),
                 "v": jax.tree.map(drawn(2e-3, True), opt_state["v"]),
                 "step": jnp.asarray(START_STEP, jnp.int32)}
    return jax.tree_util.tree_map_with_path(nonzero, params), opt_state


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want: torch.Tensor, what: str):
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * max(scale, 1.0), msg=what)


def _train_both(name, microbatches, remat, **changes):
    cfg, rcfg = _cfgs(name, microbatches=microbatches, remat=remat,
                      **changes)
    params, opt_state = _reference_state(rcfg, 0)
    model = models.build_model(cfg, "cpu")
    model.load_state_dict(lm_params_from_reference(_np(params), cfg, "cpu"))
    opt = opt_state_from_reference(_np(opt_state), model, cfg, "cpu")
    pipe = RefPipeline(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                       seed=1)
    batches = [_np(pipe.batch(s)) for s in range(STEPS)]
    rng = np.random.default_rng(2)
    for batch in batches:
        if cfg.frontend == "vision":
            batch["patches"] = rng.standard_normal(
                (BATCH, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
        if cfg.is_encdec:
            batch["frames"] = rng.standard_normal(
                (BATCH, SEQ // cfg.enc_len_ratio, cfg.frontend_dim)).astype(
                np.float32)

    step = build_train_step_fn(cfg, AdamWConfig(**OPT), device="cpu")
    ref_step = jax.jit(ref_train.build_train_step_fn(
        rcfg, RefAdamWConfig(**OPT), None))
    got, want = [], []
    for batch in batches:
        model, opt, metrics = step(model, opt, batch)
        got.append({k: float(v) for k, v in metrics.items()})
        params, opt_state, metrics = ref_step(params, opt_state, batch)
        want.append({k: float(v) for k, v in metrics.items()})
    return cfg, model, opt, params, opt_state, got, want


@pytest.mark.parametrize("name,microbatches,remat,changes", [
    *((name, m, r, {}) for name in ARCHS for m in (1, 2)
      for r in ("none", "full", "dots")), *NEW_ARCHS])
def test_train_steps_match_reference(name, microbatches, remat, changes):
    cfg, model, opt, params, opt_state, got, want = _train_both(
        name, microbatches, remat, **changes)
    for s, (g, w) in enumerate(zip(got, want)):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                       err_msg=f"step {s} {key}")
    want_params = lm_params_from_reference(_np(params), cfg, "cpu")
    for key, p in model.state_dict().items():
        _close(p, want_params[key], f"param {key}")
    want_opt = opt_state_from_reference(_np(opt_state), model, cfg, "cpu")
    for moment in ("m", "v"):
        want_m = want_opt[moment]
        for key, t in opt[moment].items():
            if t.dtype == torch.bfloat16:
                # each step rounds the fp32 moment to bf16 once: a
                # rounding-level difference may land it one ulp apart, and
                # an earlier step's ulp carries on (times b1 or b2 < 1)
                want_t = want_m[key].float()
                diff = (t.float() - want_t).abs()
                ulp = torch.ldexp(torch.ones_like(want_t),
                                  torch.frexp(want_t).exponent - 8)
                scale = float(want_t.abs().max())
                assert bool((diff <= STEPS * ulp
                             + 1e-5 * max(scale, 1.0)).all()), \
                    f"{moment} {key}"
                assert int((diff > 0).sum()) <= t.numel() // 1000, \
                    f"{moment} {key}"
            else:
                _close(t, want_m[key], f"{moment} {key}")
    assert int(opt["step"]) == int(opt_state["step"]) == START_STEP + STEPS


@pytest.mark.parametrize("s", [1000, 1024, 2048])
def test_lm_loss_matches_reference(s):
    """The one-block route (s % 1024 or s <= 1024) and the chunked one."""
    cfg, rcfg = _cfgs("qwen3-8b")
    rng = np.random.default_rng(s)
    table = rng.standard_normal((cfg.vocab, cfg.d_model)).astype(np.float32)
    head = rng.standard_normal((cfg.vocab, cfg.d_model)).astype(np.float32)
    hidden = (0.2 * rng.standard_normal((2, s, cfg.d_model))).astype(
        np.float32)
    targets = rng.integers(0, cfg.vocab, (2, s)).astype(np.int32)
    embed = Embedding(cfg, "cpu")
    with torch.no_grad():
        embed.table.copy_(torch.from_numpy(table))
        embed.head.copy_(torch.from_numpy(head))
    got = port_loss.lm_loss(embed, torch.from_numpy(hidden),
                            torch.from_numpy(targets), cfg)
    want = ref_loss.lm_loss({"table": jnp.asarray(table),
                             "head": jnp.asarray(head)},
                            jnp.asarray(hidden), jnp.asarray(targets), rcfg)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)


@pytest.mark.parametrize("name", ARCHS + tuple(a[0] for a in NEW_ARCHS))
def test_arch_smoke_forward_and_train_step(name):
    """``tests/test_models.py::test_arch_smoke_forward_and_train_step`` for
    the ported smokes, through the port."""
    cfg = configs.get_arch(name, smoke=True)
    b, s = 2, 16
    model, opt_state = init_train_state(0, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (b, s),
                         generator=torch.Generator().manual_seed(0))
    extra = {}
    if cfg.frontend == "vision":
        extra["patches"] = torch.randn(
            (b, cfg.n_patches, cfg.frontend_dim),
            generator=torch.Generator().manual_seed(1))
    if cfg.is_encdec:
        extra["frames"] = torch.randn(
            (b, s // cfg.enc_len_ratio, cfg.frontend_dim),
            generator=torch.Generator().manual_seed(1))
    hidden, aux = models.forward_train(model, toks, cfg,
                                       models.extra_input(cfg, extra))
    p = cfg.n_patches if "patches" in extra else 0
    assert hidden.shape == (b, p + s, cfg.d_model)
    assert not bool(torch.isnan(hidden).any())
    assert np.isfinite(float(aux))

    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, dims=1),
             **extra}
    cfg2 = dataclasses.replace(cfg, microbatches=1)
    step = build_train_step_fn(cfg2, AdamWConfig(warmup_steps=1,
                                                 decay_steps=10),
                               device="cpu")
    model, opt_state, metrics = step(model, opt_state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    delta = sum(float((v.float() - before[k].float()).abs().sum())
                for k, v in model.state_dict().items())
    assert delta > 0.0


def test_abstract_state_of_grok_at_full_size():
    """grok-1-314b at full size on the meta device: the config's parameter
    count, fp32 routers beside bf16 experts, bf16 moments, the reference's
    decayed set (every leaf of the scanned blocks, the routers and 3-D
    experts included; the final norm alone skipped)."""
    cfg = configs.get_arch("grok-1-314b")
    model, opt = abstract_train_state(cfg)
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    assert model.blocks[0].moe.router.dtype == torch.float32
    assert model.blocks[0].moe.w_up.shape == (8, 6144, 32768)
    assert model.blocks[0].moe.w_up.dtype == torch.bfloat16
    assert opt["m"]["blocks.0.moe.w_up"].dtype == torch.bfloat16
    assert opt["v"]["blocks.63.moe.router"].device.type == "meta"
    names = {n for n, _ in model.named_parameters()}
    assert decayed_leaves(model, cfg) == names - {"final_norm.w"}


def test_abstract_state_holds_no_memory_and_mesh_steps_wait():
    model, opt = abstract_train_state(configs.get_arch("llama3.2-3b"))
    assert all(p.device.type == "meta" for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) == \
        configs.get_arch("llama3.2-3b").param_count()
    assert opt["m"]["embed.table"].dtype == torch.float32
    assert opt["v"]["embed.table"].device.type == "meta"
    # what waited for the LM on a mesh runs: the sharded step on the 1 x 1
    # host mesh is the single-process step, bitwise, from the same state
    from repro_torch.launch.mesh import full_tensor, make_host_mesh
    from repro_torch.sharding import make_rules
    cfg, rcfg = _cfgs("qwen3-8b", microbatches=2)
    params, opt_state = _reference_state(rcfg, 0)
    runs = {}
    for kind in ("single", "mesh"):
        model = models.build_model(cfg, "cpu")
        model.load_state_dict(lm_params_from_reference(_np(params), cfg,
                                                       "cpu"))
        opt = opt_state_from_reference(_np(opt_state), model, cfg, "cpu")
        if kind == "single":
            step = build_train_step_fn(cfg, AdamWConfig(**OPT),
                                       device="cpu")
        else:
            mesh = make_host_mesh((1, 1), device_type="cpu")
            step = make_train_step(cfg, AdamWConfig(**OPT), mesh,
                                   make_rules(mesh), model, opt)
        pipe = RefPipeline(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                           seed=1)
        losses = []
        for s in range(2):
            model, opt, metrics = step(model, opt, _np(pipe.batch(s)))
            losses.append(float(metrics["loss"]))
        runs[kind] = (losses, {k: full_tensor(p) for k, p in
                               model.named_parameters()})
    assert runs["single"][0] == runs["mesh"][0]
    for key, p in runs["single"][1].items():
        assert torch.equal(p, runs["mesh"][1][key]), key
    with pytest.raises(ValueError, match="pass no device"):
        build_train_step_fn(cfg, AdamWConfig(), rules=make_rules(mesh),
                            device="cpu")


def test_cpu_train_step_runs_the_plain_norms():
    """On the CPU every norm's forward and backward are the plain versions:
    no launch is counted, and every norm weight gets a gradient."""
    cfg = dataclasses.replace(configs.get_arch("qwen3-8b", smoke=True),
                              microbatches=2)
    model, opt = init_train_state(3, cfg, device="cpu")
    step = build_train_step_fn(cfg, AdamWConfig(**OPT), device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 8)),
             "targets": torch.randint(0, cfg.vocab, (4, 8))}
    _build.reset_launches()
    model, opt, _ = step(model, opt, batch)
    assert set(_build.launches.values()) == {0}
    norms = [k for k in opt["v"] if k.endswith(("ln1.w", "ln2.w", "q_norm",
                                                "k_norm", "final_norm.w"))]
    assert len(norms) == 4 * cfg.n_layers + 1
    assert all(bool((opt["v"][k] > 0).any()) for k in norms)
