"""The port's training launcher end to end on the CPU:
``tests/test_system.py``'s launcher cases through
``repro_torch.launch.train`` with ``--device cpu``.

The loss on the structured pipeline falls by more than 0.2 over 30 steps,
and the kill-and-resume drill (4 steps, a checkpoint, a relaunch with
``--resume`` to step 8) reproduces the straight run's last four losses to
the reference's 1e-4 (on the CPU they are bitwise equal: the same data,
state and arithmetic).
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro_torch.launch import train as train_launch


def _args(**kw):
    ap = train_launch.build_argparser()
    base = ["--arch", kw.pop("arch")]
    for k, v in kw.items():
        base += ([f"--{k.replace('_', '-')}"] if v == "" else
                 [f"--{k.replace('_', '-')}", str(v)])
    base += ["--smoke", "--device", "cpu"]
    return ap.parse_args(base)


def test_train_launcher_loss_decreases():
    """~100k-param model, structured data: the loss must fall measurably."""
    res = train_launch.run(_args(arch="llama3.2-3b", steps=30, batch=8,
                                 seq=64, lr="3e-3"))
    first = np.mean(res["losses"][:5])
    last = np.mean(res["losses"][-5:])
    assert last < first - 0.2, (first, last)
    assert res["final_step"] == 30 and res["monitor"]["steps"] == 30
    assert len(res["grad_norms"]) == len(res["seconds"]) == 30


def test_train_restart_is_seamless(tmp_path):
    """Kill-and-resume drill: 4 + 4 resumed steps ≡ 8 straight steps."""
    ck1 = str(tmp_path / "a")
    ck2 = str(tmp_path / "b")
    r_full = train_launch.run(_args(arch="qwen3-8b", steps=8, batch=4,
                                    seq=32, ckpt_dir=ck1, ckpt_every=4,
                                    decay_steps=8))
    train_launch.run(_args(arch="qwen3-8b", steps=4, batch=4, seq=32,
                           ckpt_dir=ck2, ckpt_every=4, decay_steps=8))
    r_resumed = train_launch.run(_args(arch="qwen3-8b", steps=8, batch=4,
                                       seq=32, ckpt_dir=ck2, ckpt_every=4,
                                       decay_steps=8, resume=""))
    np.testing.assert_allclose(r_full["losses"][4:], r_resumed["losses"],
                               rtol=1e-4, atol=1e-4)
    assert r_full["losses"][4:] == r_resumed["losses"]
    for name, p in r_full["params"].named_parameters():
        assert torch.equal(p, dict(r_resumed["params"].named_parameters())[
            name]), name


def test_launcher_refuses_what_waits_for_a_mesh():
    """The production meshes parse and are refused by the mesh module on a
    process without their 256 / 512 ranks (never run on the host mesh
    instead); every profile trains on the host mesh; the enc-dec arch takes
    one step on its frames."""
    ap = train_launch.build_argparser()
    for mesh, ranks in (("single", 256), ("multi", 512)):
        args = ap.parse_args(["--arch", "qwen3-8b", "--smoke", "--mesh",
                              mesh, "--device", "cpu", "--steps", "1"])
        with pytest.raises(ValueError, match=f"needs {ranks} ranks"):
            train_launch.run(args)
    with pytest.raises(SystemExit):
        ap.parse_args(["--arch", "llama3.2-3b", "--profile", "zero3"])
    losses = {}
    for profile in ("fsdp", "dp_tp", "zero1"):
        losses[profile] = train_launch.run(_args(
            arch="qwen3-8b", steps=2, batch=4, seq=16,
            profile=profile))["losses"]
    assert losses["fsdp"] == losses["dp_tp"] == losses["zero1"]
    res = train_launch.run(_args(arch="seamless-m4t-medium", steps=1,
                                 batch=2, seq=16))
    assert res["final_step"] == 1 and np.isfinite(res["losses"]).all()


def test_vision_batches_carry_patches_keyed_by_step():
    """A vision arch's batch holds (B, n_patches, frontend_dim) fp32
    normals keyed by (seed + 2, step): the same step gives the same
    patches, another step or seed others, and a dense arch none."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline

    cfg = get_arch("phi-3-vision-4.2b", smoke=True)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=0)
    a = train_launch.make_batch(pipe, cfg, 0, 3)
    assert a["patches"].shape == (4, cfg.n_patches, cfg.frontend_dim)
    assert a["patches"].dtype == np.float32
    np.testing.assert_array_equal(
        a["patches"], train_launch.make_batch(pipe, cfg, 0, 3)["patches"])
    for seed, step in ((0, 4), (1, 3)):
        assert not np.array_equal(
            a["patches"],
            train_launch.make_batch(pipe, cfg, seed, step)["patches"])
    np.testing.assert_array_equal(a["tokens"], pipe.batch(3)["tokens"])
    assert "patches" not in train_launch.make_batch(
        pipe, get_arch("qwen3-8b", smoke=True), 0, 3)


def test_encdec_batches_carry_frames_keyed_by_step():
    """An enc-dec arch's batch holds (B, max(S // enc_len_ratio, 1),
    frontend_dim) fp32 normals keyed by (seed + 1, step): the same step
    gives the same frames, another step or seed others; a decoder-only
    arch none."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline

    cfg = get_arch("seamless-m4t-medium", smoke=True)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=0)
    a = train_launch.make_batch(pipe, cfg, 0, 3)
    assert a["frames"].shape == (4, 16 // cfg.enc_len_ratio,
                                 cfg.frontend_dim)
    assert a["frames"].dtype == np.float32 and "patches" not in a
    np.testing.assert_array_equal(
        a["frames"], train_launch.make_batch(pipe, cfg, 0, 3)["frames"])
    for seed, step in ((0, 4), (1, 3)):
        assert not np.array_equal(
            a["frames"],
            train_launch.make_batch(pipe, cfg, seed, step)["frames"])
    short = TokenPipeline(vocab=cfg.vocab, seq_len=2, global_batch=4, seed=0)
    assert train_launch.make_batch(short, cfg, 0, 0)["frames"].shape[1] == 1
    assert "frames" not in train_launch.make_batch(
        pipe, get_arch("mamba2-1.3b", smoke=True), 0, 3)


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b",
                                  "granite-moe-1b-a400m", "mamba2-1.3b",
                                  "recurrentgemma-9b", "seamless-m4t-medium"])
def test_new_archs_train_through_the_launcher(arch):
    """The vision, MoE, SSD, RG-LRU and enc-dec smokes train end to end:
    finite losses, and the loss falls over 12 steps."""
    res = train_launch.run(_args(arch=arch, steps=12, batch=4, seq=32,
                                 lr="3e-3"))
    assert np.isfinite(res["losses"]).all()
    assert np.mean(res["losses"][-3:]) < np.mean(res["losses"][:3])
