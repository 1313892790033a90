"""The LM on a mesh: ``repro_torch``'s sharded train, prefill and decode
steps in spawned gloo ranks, against the port's single-process steps and
the reference's ``build_train_step_fn`` from the same state.

The state is the one ``tests/test_torch_train.py`` steps from: qwen3-8b's
smoke (and granite-moe's, its MoE load-balance statistics summed over the
batch axes) in fp32 with 2 microbatches, the reference's ``init_train_state``
weights (its zero-initialised norm weights drawn non-zero with numpy) and
a resumed optimizer state (moments drawn with numpy at step 10), carried
over by ``convert``. This process computes two steps of the reference
(``jax.jit`` of ``repro.runtime.train.build_train_step_fn``, one device)
and of the port's single-process step, and writes the state for the ranks.

Two spawns of 8 gloo ranks, the reference's ``(4, 2)`` and ``(2, 2, 2)``
meshes (``tests/test_distributed.py`` scenarios 4–8), each with its own
timeout that kills its ranks; each rank imports only torch:

* the train step under ``fsdp``, ``dp_tp`` and ``zero1`` (two steps; the
  (2, 2, 2) spawn is the multi-pod step; granite-moe under ``fsdp``): losses and, after the steps,
  every parameter and both moments within rtol 1e-5 / atol
  1e-5·max(scale, 1) of the port's single process and of the reference;
  every rank holds its blocks placed by the rules' specs; replicated
  leaves hold the same bits on every rank;
* the elastic checkpoint: saved on (4, 2) after the fsdp steps (written
  once, assembled), restored onto (2, 2, 2) and onto no mesh, bitwise;
* the sharded prefill and four decode steps: logits within 1e-5 of the
  single-process steps, the cache placed by ``cache_specs`` and its
  position advanced.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_lm_mesh.py``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro import configs as ref_configs
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.runtime import train as ref_train
from repro_torch import configs, models
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import (lm_params_from_reference,
                                 opt_state_from_reference)
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train import build_train_step_fn

ROOT = Path(__file__).resolve().parents[1]
#: the archs trained on the meshes, and their profiles
ARCHS = {"qwen3-8b": ("fsdp", "dp_tp", "zero1"),
         "granite-moe-1b-a400m": ("fsdp",)}
STEPS, BATCH, SEQ = 2, 8, 16
OPT = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=100)
MESHES = ("4x2", "2x2x2")        # spawned in this order: 2x2x2 restores 4x2's
SPAWN_TIMEOUT_S = 240
TOL = 1e-5


def _cfgs(arch):
    changes = dict(microbatches=2, param_dtype="float32",
                   compute_dtype="float32")
    return (dataclasses.replace(configs.get_arch(arch, smoke=True),
                                **changes),
            dataclasses.replace(ref_configs.get_arch(arch, smoke=True),
                                **changes))


def _reference_state(rcfg, seed=0):
    """The reference's params (zero-initialised leaves drawn non-zero) and
    a resumed optimizer state: m ~ 1e-3·N(0, 1), v = (2e-3·N(0, 1))² +
    1e-6 at step 10 (as ``tests/test_torch_train.py``)."""
    params, opt_state = ref_train.init_train_state(jax.random.PRNGKey(seed),
                                                   rcfg)
    rng = np.random.default_rng(seed)

    def nonzero(path, leaf):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("'w'", "q_norm", "k_norm")):
            return jnp.asarray(0.1 * rng.standard_normal(leaf.shape),
                               leaf.dtype)
        return leaf

    def drawn(scale, square):
        def one(leaf):
            z = scale * rng.standard_normal(leaf.shape)
            return jnp.asarray(z * z + 1e-6 if square else z, leaf.dtype)
        return one
    opt_state = {"m": jax.tree.map(drawn(1e-3, False), opt_state["m"]),
                 "v": jax.tree.map(drawn(2e-3, True), opt_state["v"]),
                 "step": jnp.asarray(10, jnp.int32)}
    return jax.tree_util.tree_map_with_path(nonzero, params), opt_state


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat_state(model, opt) -> dict:
    out = {f"p.{k}": v.detach().numpy() for k, v in
           model.named_parameters()}
    for key in ("m", "v"):
        out.update({f"{key}.{k}": v.numpy() for k, v in opt[key].items()})
    return out


_WORKER = r'''
import datetime, json, sys
import dataclasses
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, spec, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4], sys.argv[5])
ARCHS = json.loads(sys.argv[6])
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
torch.set_num_threads(1)

from repro_torch import configs, models
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch.mesh import (active_axes, full_tensor, gather_stack,
                                     make_host_mesh)
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.serve import (build_decode_fn, build_prefill_fn,
                                       make_decode_step, make_prefill_step)
from repro_torch.runtime.train import build_train_step_fn, make_train_step
from repro_torch.sharding import make_rules, named, param_specs
from repro_torch.sharding.rules import P, cache_leaves, cache_specs

if spec == "4x2":
    mesh = make_host_mesh((4, 2), ("data", "model"), device_type="cpu")
else:
    mesh = make_host_mesh((2, 2, 2), ("pod", "data", "model"),
                          device_type="cpu")
OPT = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=100)


def load(arch):
    global cfg, state, batches
    cfg = dataclasses.replace(configs.get_arch(arch, smoke=True),
                              microbatches=2, param_dtype="float32",
                              compute_dtype="float32")
    state = np.load(f"{tmp}/state_{arch}.npz")
    batches = [dict(np.load(f"{tmp}/batch_{arch}_{s}.npz"))
               for s in range(2)]


def verdict(name, ok, detail=""):
    if rank == 0:
        print(json.dumps({"name": name, "ok": bool(ok),
                          "detail": str(detail)}), flush=True)


def scenario(name, fn):
    try:
        ok, detail = fn()
    except Exception as e:                      # a verdict, not a hang
        import traceback
        traceback.print_exc()
        ok, detail = False, repr(e)
    verdict(name, ok, detail)


def fresh():
    model = models.build_model(cfg, "cpu")
    model.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in
                           state.items() if k.startswith("p.")})
    opt = {key: {k[2:]: torch.from_numpy(v.copy()) for k, v in
                 state.items() if k.startswith(key + ".")}
           for key in ("m", "v")}
    opt["step"] = torch.tensor(10, dtype=torch.int32)
    return model, opt


def same_on_replicas(tensors):
    for t in tensors:
        axes = active_axes(mesh, [a for a, p in zip(mesh.mesh_dim_names,
                                                    t.placements)
                                  if p.is_replicate()])
        if axes:
            stack = gather_stack(t.to_local().contiguous(), mesh, axes)
            if not all(torch.equal(stack[0], x) for x in stack[1:]):
                return False
    return True


def train(arch, profile):
    rules = make_rules(mesh, fsdp=(profile == "fsdp"))
    opt_rules = make_rules(mesh, fsdp=True) if profile == "zero1" else None
    model, opt = fresh()
    step = make_train_step(cfg, AdamWConfig(**OPT), mesh, rules, model, opt,
                           batches[0], opt_rules=opt_rules)
    losses = []
    for batch in batches:
        model, opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["loss"]))
    # each leaf placed as its spec names
    specs = param_specs(cfg, model, rules)
    o_specs = param_specs(cfg, model, opt_rules or rules)
    placed = all(tuple(p.placements) == tuple(named(mesh, specs[n]))
                 for n, p in model.named_parameters())
    placed &= all(tuple(t.placements) == tuple(named(mesh, o_specs[n]))
                  for k in ("m", "v") for n, t in opt[k].items())
    out = {f"p.{n}": full_tensor(p).detach().numpy()
           for n, p in model.named_parameters()}
    for k in ("m", "v"):
        out.update({f"{k}.{n}": full_tensor(t).numpy()
                    for n, t in opt[k].items()})
    if rank == 0:
        np.savez(f"{tmp}/train_{spec}_{arch}_{profile}.npz",
                 losses=np.array(losses), **out)
    same = same_on_replicas(list(model.parameters())
                            + [t for k in ("m", "v") for t in opt[k].values()])
    agree = gather_stack(torch.tensor(losses, dtype=torch.float64), mesh,
                         mesh.mesh_dim_names)
    same_loss = all(torch.equal(agree[0], x) for x in agree)
    if arch == "qwen3-8b" and profile == "fsdp" and spec == "4x2":
        mgr = CheckpointManager(f"{tmp}/ckpt")
        mgr.save(STEPS_DONE, {"params": dict(model.named_parameters()),
                              "opt": opt}, blocking=False)
        mgr.wait()
    verdict(f"train_{arch}_{profile}_placed", placed)
    verdict(f"train_{arch}_{profile}_replicas_same", same and same_loss,
            f"replicas {same}, losses {same_loss}")
    return True, losses


STEPS_DONE = 2
for arch, profiles in ARCHS.items():
    load(arch)
    for profile in profiles:
        scenario(f"train_{arch}_{profile}", lambda: train(arch, profile))
load("qwen3-8b")


def elastic():
    """4x2's checkpoint restored onto this mesh, bitwise."""
    want = np.load(f"{tmp}/train_4x2_qwen3-8b_fsdp.npz")
    model, opt = fresh()
    rules = make_rules(mesh)
    specs = param_specs(cfg, model, rules)
    template = {"params": dict(model.named_parameters()), "opt": opt}
    got, meta = CheckpointManager(f"{tmp}/ckpt").restore(
        template, mesh=mesh, specs={"params": specs,
                                    "opt": {"m": specs, "v": specs,
                                            "step": P()}})
    ok = meta["step"] == 2 and int(got["opt"]["step"].to_local()) == 12
    for n, t in got["params"].items():
        ok &= tuple(t.placements) == tuple(named(mesh, specs[n]))
        ok &= np.array_equal(full_tensor(t).numpy(), want[f"p.{n}"])
    for k in ("m", "v"):
        for n, t in got["opt"][k].items():
            ok &= np.array_equal(full_tensor(t).numpy(), want[f"{k}.{n}"])
    return bool(ok), meta["step"]


if spec == "2x2x2":
    scenario("elastic_restore", elastic)


def decode():
    """Prefill and four decode steps on the mesh against one process."""
    rules = make_rules(mesh)
    tokens = batches[0]["tokens"]
    max_len = tokens.shape[1] + 4
    one, _ = fresh()
    placed, _ = fresh()
    want, c1 = build_prefill_fn(cfg, max_len, device="cpu")(
        one, {"tokens": tokens})
    got, c2 = make_prefill_step(cfg, mesh, rules, placed,
                                {"tokens": tokens}, max_len)(
        placed, {"tokens": tokens})
    errs = [float((full_tensor(got) - want).abs().max())]
    scale = float(want.abs().max())
    step1 = build_decode_fn(cfg, device="cpu")
    step2 = make_decode_step(cfg, mesh, rules, placed, c2)
    for _ in range(4):
        token = want[:, -1].argmax(-1, keepdim=True)
        want, c1 = step1(one, token, c1)
        got, c2 = step2(placed, token, c2)
        errs.append(float((full_tensor(got) - want).abs().max()))
        scale = max(scale, float(want.abs().max()))
    specs = cache_specs(cfg, c2, rules)
    placed_ok = all(tuple(getattr(o, f).placements)
                    == tuple(named(mesh, specs[n]))
                    for n, o, f in cache_leaves(c2))
    ok = (max(errs) <= 1e-5 * max(scale, 1.0) and c2.pos == c1.pos
          == tokens.shape[1] + 4 and placed_ok)
    return ok, f"max err {max(errs)}, pos {c2.pos}, placed {placed_ok}"


scenario("decode_sharded", decode)
dist.destroy_process_group()
'''


def _spawn(spec: str, tmp: Path) -> dict:
    """The worker on 8 gloo ranks (file-store rendezvous in ``tmp``); every
    rank killed past the timeout. Returns rank 0's verdicts."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    store = tmp / f"store_{spec}"
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(rank), "8",
                               str(store), spec, str(tmp),
                               json.dumps(ARCHS)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in range(8)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=SPAWN_TIMEOUT_S))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=SPAWN_TIMEOUT_S)
    verdicts = {}
    for line in outputs[0][0].splitlines():
        try:
            v = json.loads(line)
            verdicts[v["name"]] = v
        except (json.JSONDecodeError, KeyError):
            continue
    codes = [p.returncode for p in procs]
    if any(codes) or not verdicts:
        raise RuntimeError(f"{spec}: ranks exited {codes}\n"
                           + "\n".join(err[-2000:] for _, err in outputs))
    return verdicts


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The state written for the ranks, the reference's and the port's
    single-process steps from it, and both spawns' verdicts."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    out = {"tmp": tmp, "cfg": _cfgs("qwen3-8b")[0]}
    for arch in ARCHS:
        cfg, rcfg = _cfgs(arch)
        params, opt_state = _reference_state(rcfg)
        model = models.build_model(cfg, "cpu")
        model.load_state_dict(lm_params_from_reference(_np(params), cfg,
                                                       "cpu"))
        opt = opt_state_from_reference(_np(opt_state), model, cfg, "cpu")
        np.savez(tmp / f"state_{arch}.npz", **_flat_state(model, opt))
        pipe = RefPipeline(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                           seed=1)
        batches = [_np(pipe.batch(s)) for s in range(STEPS)]
        for s, batch in enumerate(batches):
            np.savez(tmp / f"batch_{arch}_{s}.npz", **batch)
        single = build_train_step_fn(cfg, AdamWConfig(**OPT), device="cpu")
        ref_step = jax.jit(ref_train.build_train_step_fn(
            rcfg, RefAdamWConfig(**OPT), None))
        port_losses, ref_losses = [], []
        for batch in batches:
            model, opt, metrics = single(model, opt, batch)
            port_losses.append(float(metrics["loss"]))
            params, opt_state, metrics = ref_step(params, opt_state, batch)
            ref_losses.append(float(metrics["loss"]))
        ref_model = models.build_model(cfg, "cpu")
        ref_model.load_state_dict(lm_params_from_reference(_np(params), cfg,
                                                           "cpu"))
        ref_opt = opt_state_from_reference(_np(opt_state), ref_model, cfg,
                                           "cpu")
        out[arch] = {"port": (port_losses, _flat_state(model, opt)),
                     "reference": (ref_losses, _flat_state(ref_model,
                                                           ref_opt))}
    out["verdicts"] = {spec: _spawn(spec, tmp) for spec in MESHES}
    return out


def _close(got: np.ndarray, want: np.ndarray) -> bool:
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = np.abs(got.astype(np.float64) - want)
    return bool((err <= TOL * max(scale, 1.0) + TOL * np.abs(want)).all())


TRAINED = [(arch, profile) for arch, profiles in ARCHS.items()
           for profile in profiles]


@pytest.mark.parametrize("against", ["port", "reference"])
@pytest.mark.parametrize("arch,profile", TRAINED)
@pytest.mark.parametrize("spec", MESHES)
def test_sharded_train_step_matches_single_process(runs, spec, arch, profile,
                                                   against):
    """Losses, parameters and moments after two steps on the mesh against
    the port's single process and the reference's step."""
    v = runs["verdicts"][spec][f"train_{arch}_{profile}"]
    assert v["ok"], v["detail"]
    got = np.load(runs["tmp"] / f"train_{spec}_{arch}_{profile}.npz")
    want_losses, want = runs[arch][against]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=TOL)
    bad = [k for k, w in want.items() if not _close(got[k], w)]
    assert not bad, f"{spec} {arch} {profile} vs {against}: {bad[:5]}"


@pytest.mark.parametrize("arch,profile", TRAINED)
@pytest.mark.parametrize("spec", MESHES)
def test_leaves_are_placed_and_replicas_hold_the_same_bits(runs, spec, arch,
                                                           profile):
    for name in (f"train_{arch}_{profile}_placed",
                 f"train_{arch}_{profile}_replicas_same"):
        v = runs["verdicts"][spec][name]
        assert v["ok"], f"{spec} {name}: {v['detail']}"


def test_elastic_checkpoint_restores_onto_another_mesh_and_onto_none(runs):
    """Saved on (4, 2), restored onto (2, 2, 2) in the ranks and onto no
    mesh here: bitwise the assembled state it saved."""
    v = runs["verdicts"]["2x2x2"]["elastic_restore"]
    assert v["ok"], v["detail"]
    cfg = runs["cfg"]
    model = models.build_model(cfg, "cpu")
    opt = {k: {n: torch.zeros_like(p) for n, p in model.named_parameters()}
           for k in ("m", "v")}
    opt["step"] = torch.zeros((), dtype=torch.int32)
    got, meta = CheckpointManager(str(runs["tmp"] / "ckpt")).restore(
        {"params": dict(model.named_parameters()), "opt": opt})
    want = np.load(runs["tmp"] / "train_4x2_qwen3-8b_fsdp.npz")
    assert meta["step"] == 2 and int(got["opt"]["step"]) == 12
    for n, t in got["params"].items():
        assert np.array_equal(t.detach().numpy(), want[f"p.{n}"]), n
    for k in ("m", "v"):
        for n, t in got["opt"][k].items():
            assert np.array_equal(t.numpy(), want[f"{k}.{n}"]), (k, n)


@pytest.mark.parametrize("spec", MESHES)
def test_sharded_decode_matches_single_process(runs, spec):
    v = runs["verdicts"][spec]["decode_sharded"]
    assert v["ok"], v["detail"]


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-1.3b",
                                  "granite-moe-1b-a400m"])
def test_one_rank_mesh_serves_as_one_process(arch):
    """On a 1 x 1 gloo mesh in this process the sharded prefill and decode
    issue no collective and give the single-process logits bitwise; the
    parameters and the cache stay placed between steps, a new cache is
    placed on its first step, and a batch that is not the cache's is
    refused."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.runtime.serve import (build_decode_fn, build_prefill_fn,
                                           make_decode_step,
                                           make_prefill_step)
    from repro_torch.runtime.train import init_train_state
    from repro_torch.sharding import make_rules
    from repro_torch.sharding.rules import cache_leaves

    cfg = dataclasses.replace(configs.get_arch(arch, smoke=True),
                              param_dtype="float32", compute_dtype="float32")
    mesh = mesh_mod.make_host_mesh((1, 1), device_type="cpu")
    rules = make_rules(mesh)
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(3))
    one, _ = init_train_state(3, cfg, device="cpu")
    placed, _ = init_train_state(3, cfg, device="cpu")
    prefill1 = build_prefill_fn(cfg, 16, device="cpu")
    decode1 = build_decode_fn(cfg, device="cpu")
    prefill2 = make_prefill_step(cfg, mesh, rules, placed,
                                 {"tokens": tokens}, 16)
    decode2 = make_decode_step(cfg, mesh, rules, placed, None)
    mesh_mod.reset_gathered()
    for _ in range(2):               # the second time on a new cache
        want, c1 = prefill1(one, {"tokens": tokens})
        got, c2 = prefill2(placed, {"tokens": tokens})
        assert torch.equal(mesh_mod.full_tensor(got), want)
        for _ in range(3):
            token = want[:, -1].argmax(-1, keepdim=True)
            want, c1 = decode1(one, token, c1)
            got, c2 = decode2(placed, token, c2)
            assert isinstance(got, DTensor)
            assert torch.equal(mesh_mod.full_tensor(got), want)
        assert c2.pos == c1.pos == tokens.shape[1] + 3
        assert all(isinstance(getattr(o, f), DTensor)
                   for _, o, f in cache_leaves(c2))
        assert all(isinstance(p, DTensor) for p in placed.parameters())
    assert mesh_mod.gathered["calls"] == 0
    with pytest.raises(ValueError, match="tokens for a cache of 2 rows"):
        decode2(placed, tokens[:1, :1], c2)
