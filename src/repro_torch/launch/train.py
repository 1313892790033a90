"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--device cpu]``.

The counterpart of ``repro/launch/train.py``, wiring the same layers:
config registry → ``TokenPipeline`` → ``init_train_state`` → the mesh
(``--mesh``) and its sharding rules (``--profile``) → ``make_train_step``
(microbatches, remat, AdamW, on the mesh) → ``CheckpointManager`` (atomic,
async, elastic) → ``StepMonitor``. It runs on the card unless ``--device
cpu`` is given, and builds the kernels before the first step's clock.

``--mesh host`` is the 1 x 1 ``("data", "model")`` mesh over this process
(``launch.mesh.make_host_mesh``): every axis has one rank, so the step
issues no collective and is the single-process step. ``single`` and
``multi`` are the reference's (16, 16) and (2, 16, 16) production meshes,
which need 256 and 512 ranks: on a process group without them the mesh
module refuses them, and nothing runs on the host mesh instead.
``--profile`` picks the rules: ``fsdp`` (weights and moments sharded over
the DP axes), ``dp_tp`` (replicated over them) or ``zero1`` (``dp_tp``
weights, FSDP moments). ``--resume`` restores the checkpoint onto the mesh
by the rules' specs (the elastic restore).

Fault-tolerance drill: train 4 steps with a checkpoint at step 4, kill,
relaunch with ``--resume``: the run resumes from step 4 on the same data
(the pipeline is keyed by step) and the same state, so its losses are the
straight run's. Pin ``--decay-steps`` to the full horizon for such a run, so
the schedule does not depend on where it stopped.

A vision arch's batches carry random patch embeddings (``make_batch``)
drawn from numpy keyed by ``(seed + 2, step)``, and an enc-dec arch's
random audio frame embeddings keyed by ``(seed + 1, step)``: like the
reference's ``fold_in(PRNGKey(seed + 2), step)`` and ``fold_in(PRNGKey(seed
+ 1), step)`` they depend on the step alone, but they are not its numbers
(ROADMAP.md, queue 3).

"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.monitor import StepMonitor
from repro_torch.runtime.train import (init_train_state, make_train_step,
                                       place_train_state)
from repro_torch.sharding.rules import P, make_rules, param_specs


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--decay-steps", type=int, default=0,
                    help="cosine decay horizon (default: --steps); set it "
                         "explicitly when a run will be interrupted and "
                         "resumed, so the schedule is restart-invariant")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"],
                    help="host: the 1 x 1 mesh over this process; single / "
                         "multi: the (16, 16) / (2, 16, 16) production "
                         "meshes (256 / 512 ranks)")
    ap.add_argument("--profile", default="fsdp",
                    choices=["fsdp", "dp_tp", "zero1"],
                    help="sharding profile: fsdp = weights and moments "
                         "sharded over the DP axes; dp_tp = replicated "
                         "weights + TP; zero1 = dp_tp weights with "
                         "FSDP-sharded moments")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def make_batch(pipe: TokenPipeline, cfg, seed: int, step: int) -> dict:
    """The pipeline's batch of ``step``; for an enc-dec arch ``"frames"``
    (B, max(S // enc_len_ratio, 1), frontend_dim) fp32 standard normals
    keyed by ``(seed + 1, step)``, and for a vision arch ``"patches"``
    (B, n_patches, frontend_dim) keyed by ``(seed + 2, step)``."""
    batch = pipe.batch(step)
    b, s = np.shape(batch["tokens"])
    if cfg.is_encdec:
        rng = np.random.default_rng(np.random.SeedSequence([seed + 1, step]))
        batch["frames"] = rng.standard_normal(
            (b, max(s // cfg.enc_len_ratio, 1), cfg.frontend_dim),
            dtype=np.float32)
    if cfg.frontend == "vision":
        rng = np.random.default_rng(np.random.SeedSequence([seed + 2, step]))
        batch["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.frontend_dim),
            dtype=np.float32)
    return batch


def make_mesh(kind: str, device_type: str):
    """The mesh ``--mesh`` names, on ``device_type``."""
    if kind == "host":
        return make_host_mesh((1, 1), ("data", "model"), device_type)
    return make_production_mesh(multi_pod=(kind == "multi"),
                                device_type=device_type)


def run(args) -> dict:
    """Train ``args.steps`` steps; returns ``{"losses", "monitor",
    "final_step"}`` as the reference does, and beside them each step's
    ``grad_norms`` and ``seconds``, and the final ``params`` (the model,
    its parameters ``DTensor``s placed on the mesh) and ``opt`` state."""
    dev = resolve_device(args.device)
    mesh = make_mesh(args.mesh, dev.type)
    rules = make_rules(mesh, fsdp=(args.profile == "fsdp"))
    opt_rules = make_rules(mesh, fsdp=True) if args.profile == "zero1" \
        else None
    cfg = get_arch(args.arch, smoke=args.smoke)
    cfg = dataclasses.replace(cfg, microbatches=min(cfg.microbatches,
                                                    max(args.batch // 2, 1)))
    horizon = args.decay_steps or args.steps
    opt = AdamWConfig(peak_lr=args.lr, warmup_steps=max(horizon // 10, 1),
                      decay_steps=horizon)
    if dev.type == "cuda":
        _build.library()                 # build before the first step's clock

    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)
    params, opt_state = init_train_state(args.seed, cfg, device=dev)
    place_train_state(cfg, params, opt_state, rules, opt_rules)

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        if args.resume and ckpt.latest_step() is not None:
            specs = param_specs(cfg, params, rules)
            o_specs = param_specs(cfg, params, opt_rules or rules)
            state = {"params": dict(params.named_parameters()),
                     "opt": opt_state}
            state, meta = ckpt.restore(
                state, mesh=mesh,
                specs={"params": specs, "opt": {"m": o_specs, "v": o_specs,
                                                "step": P()}})
            with torch.no_grad():
                for name, p in params.named_parameters():
                    p.to_local().copy_(state["params"][name].to_local())
            opt_state = state["opt"]
            opt_state["step"] = opt_state["step"].to_local()
            start_step = meta["step"]
            print(f"[resume] from step {start_step}")

    step_fn = make_train_step(cfg, opt, mesh, rules, params, opt_state,
                              make_batch(pipe, cfg, args.seed, start_step),
                              opt_rules=opt_rules)
    monitor = StepMonitor()
    losses, grad_norms, seconds = [], [], []
    for step in range(start_step, args.steps):
        batch = make_batch(pipe, cfg, args.seed, step)
        monitor.start()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])        # waits for the step
        rec = monitor.stop(step)
        losses.append(loss)
        grad_norms.append(float(metrics["grad_norm"]))
        seconds.append(rec.seconds)
        if step % args.log_every == 0:
            flag = " STRAGGLER" if rec.straggler else ""
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {grad_norms[-1]:.3f} "
                  f"{rec.seconds * 1e3:.0f}ms{flag}")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": dict(params.named_parameters()),
                                 "opt": opt_state},
                      metadata={"arch": cfg.name}, blocking=False)
    if ckpt:
        ckpt.save(args.steps, {"params": dict(params.named_parameters()),
                               "opt": opt_state},
                  metadata={"arch": cfg.name})
        ckpt.wait()
    print(f"[monitor] {monitor.summary()}")
    return {"losses": losses, "monitor": monitor.summary(),
            "final_step": args.steps, "grad_norms": grad_norms,
            "seconds": seconds, "params": params, "opt": opt_state}


def main(argv=None) -> int:
    run(build_argparser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
