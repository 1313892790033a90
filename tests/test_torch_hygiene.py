"""The port's boundaries: it imports no JAX and nothing of the reference,
its entry points run on the card unless asked for the CPU (and raise when
there is no card), and its kernel modules import without a CUDA toolkit."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import convert, models
from repro_torch.api import ExecConfig, Workspace
from repro_torch.configs import get_arch
from repro_torch.core import (CondensedCenteredGramOperator, DistanceMatrix,
                              mantel, pcoa, random_distance_matrix)
from repro_torch.core.mantel import MantelStatistic
from repro_torch.dist import pairwise_condensed, pairwise_distances
from repro_torch.kernels import _build
from repro_torch.kernels.mantel_corr_ops import mantel_corr_op
from repro_torch.models.encdec import (EncDec, init_cache_encdec,
                                       init_params_encdec)
from repro_torch.models.rglru import init_rec_cache
from repro_torch.models.ssd import init_ssd_cache
from repro_torch.models.transformer import (Transformer, init_cache,
                                            init_params)
from repro_torch.obs import ObsConfig
from repro_torch.obs.probe import (probe_center_matvec, probe_panel_stats,
                                   probe_pcoa_matfree, probe_permute_reduce,
                                   probe_statistic, probe_stream_pass)
from repro_torch.runtime.serve import build_decode_fn, build_prefill_fn
from repro_torch.stats import (PermanovaOperatorStatistic, anosim,
                               partial_mantel, permanova, permdisp)
from repro_torch.stats.engine import permutation_test
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.data import DistanceTileStream
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train import build_train_step_fn, init_train_state
from repro_torch.serve import AnalysisService, ServeConfig
from repro_torch.tune import calibrate, detect_budget, solve_tiles

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_no_jax_and_nothing_of_the_reference(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_session_modules_are_checked():
    """The session API, the observability layer, the tuner, the analysis
    service and the LM training path are among the files the import check
    above walks."""
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in PORT_FILES if "repro_torch" in p.parts}
    assert {"api/config.py", "api/workspace.py", "api/__init__.py",
            "obs/config.py", "obs/trace.py", "obs/ledger.py",
            "obs/compile.py", "obs/report.py", "obs/__init__.py",
            "obs/metrics.py",
            "tune/__init__.py", "tune/budget.py", "tune/model.py",
            "tune/solve.py",
            "serve/__init__.py", "serve/admission.py", "serve/pool.py",
            "serve/metrics.py", "serve/scheduler.py", "serve/service.py",
            "faults/__init__.py", "faults/plan.py",
            "checkpoint/__init__.py", "checkpoint/journal.py",
            "runtime/monitor.py", "launch/__init__.py",
            "launch/serve.py",
            "data/__init__.py", "data/pipeline.py", "data/distance.py",
            "optim/__init__.py", "optim/adamw.py", "runtime/loss.py",
            "runtime/train.py", "checkpoint/manager.py",
            "launch/train.py", "kernels/rmsnorm_ops.py",
            "sharding/__init__.py", "sharding/rules.py", "sharding/ctx.py",
            "optim/compression.py", "launch/inputs.py",
            "obs/probe.py", "obs/drift.py"} <= names


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = random_distance_matrix(0, 12, device="cpu")
    x = np.abs(np.random.default_rng(0).normal(size=(12, 5))).astype(
        np.float32)
    prod = pairwise_condensed(x, device="cpu")
    op = CondensedCenteredGramOperator.from_production(prod)
    d2 = random_distance_matrix(1, 12, device="cpu")
    d3 = random_distance_matrix(2, 12, device="cpu")
    groups = np.arange(12) % 3
    lm = get_arch("qwen3-8b", smoke=True)
    seamless = get_arch("seamless-m4t-medium", smoke=True)
    calls = [
        lambda: DistanceMatrix(d.data),
        lambda: DistanceMatrix.from_numpy(d.data.numpy()),
        lambda: random_distance_matrix(0, 12),
        lambda: pcoa(d, dimensions=2),
        lambda: mantel(d, d, permutations=9),
        lambda: permutation_test(MantelStatistic(d.data, d.data, 12), 9),
        lambda: convert.from_reference({"data": d.data.numpy()}),
        lambda: pairwise_condensed(x),
        lambda: pairwise_distances(x),
        lambda: pairwise_distances(x, out="condensed"),
        lambda: pcoa(None, dimensions=2, operator=op),
        lambda: Workspace(d.data),
        lambda: Workspace(d),
        lambda: Workspace.from_features(x),
        lambda: Workspace(d.data, config=ExecConfig(device="cuda")),
        lambda: permanova(d, groups, permutations=9),
        lambda: anosim(d, groups, permutations=9),
        lambda: permdisp(d, groups, permutations=9, dimensions=2),
        lambda: partial_mantel(d, d2, d3, permutations=9),
        lambda: permutation_test(PermanovaOperatorStatistic(
            op, torch.from_numpy(groups), 12, 3), 9),
        lambda: init_params(lm, torch.Generator()),
        lambda: Transformer(lm),
        lambda: init_cache(lm, 1, 4),
        lambda: EncDec(seamless),
        lambda: init_params_encdec(seamless, torch.Generator()),
        lambda: init_cache_encdec(seamless, 1, 4, 2),
        lambda: init_rec_cache(get_arch("recurrentgemma-9b", smoke=True), 1),
        lambda: init_ssd_cache(get_arch("mamba2-1.3b", smoke=True), 1),
        lambda: models.build_model(seamless),
        lambda: models.init_model(lm, torch.Generator()),
        lambda: build_prefill_fn(lm, 8),
        lambda: build_decode_fn(lm),
        lambda: convert.lm_params_from_reference({}, lm),
        lambda: AnalysisService(),
        lambda: AnalysisService(ServeConfig(auto_tune=False)),
        lambda: detect_budget(),
        lambda: solve_tiles(12),
        lambda: Workspace(d.data, config=ExecConfig(auto=True)),
        lambda: permutation_test(MantelStatistic(d.data, d.data, 12), 9,
                                 config=ExecConfig(batch_size="auto")),
        lambda: serve_launcher.main(["--smoke"]),
        lambda: init_train_state(0, lm),
        lambda: build_train_step_fn(lm, AdamWConfig()),
        lambda: convert.opt_state_from_reference({}, None, lm),
        lambda: DistanceTileStream(n=8),
        lambda: train_launcher.main(["--arch", "qwen3-8b", "--smoke"]),
        lambda: probe_permute_reduce(12, batch=4),
        lambda: probe_panel_stats(12, 5),
        lambda: probe_center_matvec(12, k=2),
        lambda: probe_pcoa_matfree(op, k=2),
        lambda: probe_statistic(MantelStatistic(d.data, d.data, 12)),
        lambda: probe_stream_pass(64),
        lambda: calibrate(mode="probe"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_mesh_entry_points_default_to_the_card(monkeypatch):
    """The LM on a mesh runs on its mesh's device, and a mesh is on the
    card unless the CPU is asked for: without a card, the host mesh, the
    rules on it and the sharded steps built on it raise, as the launcher
    does; the abstract stand-ins are ``meta`` tensors, on no device."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.inputs import input_specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.serve import (abstract_cache, make_decode_step,
                                           make_prefill_step)
    from repro_torch.runtime.train import abstract_train_state, make_train_step
    from repro_torch.sharding import make_rules

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lm = get_arch("qwen3-8b", smoke=True)
    model, opt = abstract_train_state(lm)

    def sharded(build):
        mesh = make_host_mesh()
        return build(mesh, make_rules(mesh))
    calls = [
        lambda: make_host_mesh(),
        lambda: make_rules(make_host_mesh()),
        lambda: sharded(lambda m, r: make_train_step(lm, AdamWConfig(), m, r,
                                                     model, opt)),
        lambda: sharded(lambda m, r: make_prefill_step(lm, m, r, model, {},
                                                       8)),
        lambda: sharded(lambda m, r: make_decode_step(
            lm, m, r, model, abstract_cache(lm, 1, 8))),
        lambda: train_launcher.make_mesh("host", "cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA card"):
            call()
    cache = abstract_cache(lm, 2, 8)
    assert cache.blocks[0].k.device.type == "meta"
    specs = input_specs(lm, SHAPES["train_4k"])
    assert all(t.device.type == "meta" for t in specs.values())
    mesh = make_host_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="pass no device"):
        build_train_step_fn(lm, AdamWConfig(), rules=make_rules(mesh),
                            device="cuda")
    with pytest.raises(ValueError, match="pass no device"):
        build_prefill_fn(lm, 8, rules=make_rules(mesh), device="cpu")


def test_kernel_modules_import_without_a_toolkit():
    env = dict(os.environ, PATH="", PYTHONPATH=str(ROOT / "src"))
    code = ("import repro_torch.kernels.symhollow_ops, "
            "repro_torch.kernels.center_matvec_ops, "
            "repro_torch.kernels.permute_reduce_ops, "
            "repro_torch.kernels.pairwise_ops, "
            "repro_torch.kernels.center_ops, "
            "repro_torch.kernels.mantel_corr_ops, "
            "repro_torch.kernels.rmsnorm_ops, "
            "repro_torch.kernels.inverse_orders, "
            "repro_torch.stats, "
            "repro_torch.configs, "
            "repro_torch.models.transformer, "
            "repro_torch.runtime.serve, "
            "repro_torch.runtime.train, "
            "repro_torch.launch.train, "
            "repro_torch.launch.inputs, "
            "repro_torch.sharding, "
            "repro_torch.optim.compression, "
            "repro_torch.kernels._build as b; "
            "assert all(v == 0 for v in b.launches.values())")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


def test_build_covers_every_source_and_refuses_without_nvcc(monkeypatch):
    names = {p.name for p in _build._sources()}
    assert {"symhollow.cu", "center_matvec.cu", "permute_reduce.cu",
            "pairwise.cu", "pairwise_sparse.cu", "center.cu",
            "mantel_corr.cu", "rmsnorm.cu", "inverse_orders.cu"} <= names
    assert set(_build.launches) == {
        "symhollow", "center_matvec", "inverse_orders", "permute_reduce",
        "permute_reduce_finish", "pairwise_panel", "pairwise_sparse_panel",
        "center_pass1",
        "center_finish", "center_pass2", "mantel_corr", "mantel_corr_finish",
        "rmsnorm", "rmsnorm_bwd"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "Path", lambda p: Path("/nonexistent/nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_tf32_is_off_and_cpu_runs_launch_nothing():
    assert repro_torch.__name__ == "repro_torch"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
        is False
    _build.reset_launches()
    d = random_distance_matrix(3, 30, device="cpu")
    DistanceMatrix(d.data, device="cpu")
    pcoa(d, dimensions=2, device="cpu")
    mantel(d, d, permutations=5, device="cpu")
    assert set(_build.launches.values()) == {0}
    assert np.isfinite(d.data.numpy()).all()


def test_cpu_feature_path_launches_nothing():
    """The feature path and the materialized solves on the CPU run the
    kernels' plain versions: no launch is counted."""
    x = np.abs(np.random.default_rng(1).normal(size=(24, 6))).astype(
        np.float32)
    _build.reset_launches()
    prod = pairwise_condensed(x, device="cpu")
    op = CondensedCenteredGramOperator.from_production(prod)
    pcoa(None, dimensions=2, operator=op, device="cpu")
    ws = Workspace.from_features(x, config=ExecConfig(device="cpu"))
    ws.mantel(ws, 9)
    dm = DistanceMatrix(pairwise_distances(x, device="cpu"), device="cpu")
    pcoa(dm, dimensions=2, materialize=True, device="cpu")
    pcoa(dm, dimensions=2, method="eigh", device="cpu")
    op.materialize()
    assert set(_build.launches.values()) == {0}
    assert {"pairwise_panel", "center_pass1", "center_finish",
            "center_pass2"} <= set(_build.launches)


def test_cpu_service_launches_nothing():
    """The analysis service on the CPU (tuned at admission, every method,
    coalesced tiles) and the launcher run the kernels' plain versions: no
    launch is counted."""
    rng = np.random.default_rng(3)
    svc = AnalysisService(ServeConfig(device="cpu", batch_size=8))
    svc.upload("x", features=rng.random((20, 5)).astype(np.float32))
    svc.upload("y", random_distance_matrix(7, 20, device="cpu").data)
    svc.upload("z", features=rng.random((20, 4)).astype(np.float32))
    groups = np.arange(20) % 2
    _build.reset_launches()
    handles = [svc.submit("x", "pcoa", dimensions=2)]
    for study in ("x", "y"):
        handles += [svc.submit(study, m, grouping=groups, permutations=9)
                    for m in ("permanova", "anosim", "permdisp")]
    handles += [svc.submit("x", "mantel", other="y", permutations=17),
                svc.submit("y", "partial_mantel", other="x", control="z",
                           permutations=9)]
    svc.run()
    assert all(h.status == "done" for h in handles)
    assert svc.pool.get("x").tuned.budget.backend == "cpu"
    assert serve_launcher.main(["--smoke", "--device", "cpu",
                                "--show", "0"]) == 0
    assert set(_build.launches.values()) == {0}


def test_cpu_battery_launches_nothing():
    """The statistics battery and the materialized Mantel baseline on the
    CPU run the kernels' plain versions: no launch is counted."""
    d, y, z = (random_distance_matrix(s, 24, device="cpu") for s in (4, 5, 6))
    groups = np.arange(24) % 3
    x = np.abs(np.random.default_rng(2).normal(size=(24, 6))).astype(
        np.float32)
    op = CondensedCenteredGramOperator.from_production(
        pairwise_condensed(x, device="cpu"))
    _build.reset_launches()
    permanova(d, groups, permutations=9, device="cpu")
    anosim(d, groups, permutations=9, device="cpu")
    permdisp(d, groups, permutations=9, dimensions=3, device="cpu")
    partial_mantel(d, y, z, permutations=9, device="cpu")
    permutation_test(PermanovaOperatorStatistic(op, torch.from_numpy(groups),
                                                24, 3), 9, device="cpu")
    r = mantel_corr_op(d.data, y.data, torch.arange(24)[None].repeat(4, 1),
                       perm_batch=2)
    assert set(_build.launches.values()) == {0}
    assert bool(torch.isfinite(r).all())


def test_cpu_lm_serving_launches_nothing():
    """Prefill and decode of a dense decoder on the CPU run the rmsnorm
    kernel's plain version at every norm: no launch is counted."""
    cfg = get_arch("qwen3-8b", smoke=True)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _build.reset_launches()
    logits, cache = build_prefill_fn(cfg, 6, device="cpu")(
        model, {"tokens": torch.zeros((2, 4), dtype=torch.int32)})
    for _ in range(2):
        logits, cache = build_decode_fn(cfg, device="cpu")(
            model, logits.argmax(-1), cache)
    assert set(_build.launches.values()) == {0}
    assert "rmsnorm" in _build.launches
    assert bool(torch.isfinite(logits).all()) and cache.pos == 6


def test_cpu_session_launches_nothing():
    """A session on the CPU (admission, the whole battery square- and
    feature-backed, eigh, the report) runs the kernels' plain versions:
    no launch is counted."""
    cpu = ExecConfig(device="cpu", obs=ObsConfig(enabled=True))
    d, y, z = (random_distance_matrix(s, 24, device="cpu").data
               for s in (7, 8, 9))
    x = np.abs(np.random.default_rng(3).normal(size=(24, 6))).astype(
        np.float32)
    groups = np.arange(24) % 3
    _build.reset_launches()
    for ws in (Workspace(d, config=cpu),
               Workspace.from_features(x, config=cpu)):
        ws.pcoa(dimensions=3)
        ws.pcoa(dimensions=3, method="eigh")
        ws.permanova(groups, 9)
        ws.permdisp(groups, 9, dimensions=3)
        ws.anosim(groups, 9)
        ws.mantel(y, 9)
        ws.partial_mantel(y, z, 9)
        assert ws.report().meta["tiles"]["device"] == "cpu"
    assert set(_build.launches.values()) == {0}


def test_cpu_training_launches_nothing(tmp_path):
    """A training step on the CPU (every remat mode, microbatches), the
    launcher with a checkpoint and a resume, and the tile stream run the
    kernels' plain versions, forward and backward: no launch is counted."""
    import dataclasses

    base = get_arch("llama3.2-3b", smoke=True)
    batch = {"tokens": torch.randint(0, base.vocab, (4, 8)),
             "targets": torch.randint(0, base.vocab, (4, 8))}
    _build.reset_launches()
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=remat, microbatches=2)
        model, opt = init_train_state(0, cfg, device="cpu")
        step = build_train_step_fn(cfg, AdamWConfig(), device="cpu")
        model, opt, metrics = step(model, opt, batch)
        assert np.isfinite(float(metrics["loss"]))
    args = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--steps",
            "2", "--batch", "2", "--seq", "8", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "1"]
    assert train_launcher.main(args) == 0
    assert train_launcher.main(args[:-2] + ["--steps", "3", "--resume"]) == 0
    DistanceTileStream(n=20, tile=8, device="cpu").dense()
    assert set(_build.launches.values()) == {0}
    assert {"rmsnorm", "rmsnorm_bwd"} <= set(_build.launches)
