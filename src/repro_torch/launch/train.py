"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--device cpu]``.

The counterpart of ``repro/launch/train.py``, wiring the same layers on one
card: config registry → ``TokenPipeline`` → ``init_train_state`` →
``build_train_step_fn`` (microbatches, remat, AdamW) → ``CheckpointManager``
(atomic, async) → ``StepMonitor``. It runs on the card unless ``--device
cpu`` is given, and builds the kernels before the first step's clock.

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

``--mesh`` takes only ``host`` (one card) and ``--profile`` only its default:
the sharded meshes and profiles wait for the LM on a mesh (ROADMAP.md, item
13.4).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.monitor import StepMonitor
from repro_torch.runtime.train import build_train_step_fn, init_train_state


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
    ap.add_argument("--mesh", default="host", choices=["host"],
                    help="host: one card (the sharded meshes wait for the "
                         "LM on a mesh)")
    ap.add_argument("--profile", default="fsdp", choices=["fsdp"],
                    help="accepted at its default only: on one card there "
                         "is nothing to shard")
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


def run(args) -> dict:
    """Train ``args.steps`` steps; returns ``{"losses", "monitor",
    "final_step"}`` as the reference does, and beside them each step's
    ``grad_norms`` and ``seconds``, and the final ``params`` (the model) and
    ``opt`` state."""
    dev = resolve_device(args.device)
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

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        if args.resume and ckpt.latest_step() is not None:
            state = {"params": dict(params.named_parameters()),
                     "opt": opt_state}
            state, meta = ckpt.restore(state, device=dev)
            params.load_state_dict(state["params"])
            opt_state = state["opt"]
            start_step = meta["step"]
            print(f"[resume] from step {start_step}")

    step_fn = build_train_step_fn(cfg, opt, device=dev)
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
