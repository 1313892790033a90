"""The port's ``CheckpointManager`` (``repro_torch.checkpoint.manager``).

``tests/test_runtime.py``'s four checkpoint cases through the port, a bf16
round trip, a restore onto another device's template, and the async save's
snapshot: a save with ``blocking=False`` followed at once by an in-place
update of the saved tensors must restore the state at the save. Every
round trip is exact.
"""

import os

import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro_torch.checkpoint import CheckpointManager


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "nested": {"b": torch.arange(6).reshape(2, 3).to(torch.bfloat16)},
            "step": torch.tensor(seed, dtype=torch.int32)}


def _wait(mgr):
    """``mgr.wait()``, with its writer thread given at most 300 s."""
    if mgr._thread is not None:
        mgr._thread.join(300)
        assert not mgr._thread.is_alive(), \
            "the async checkpoint write still runs after 300 s"
    mgr.wait()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree(1)
    mgr.save(5, tree, metadata={"note": "x"})
    got, meta = mgr.restore(tree)
    assert meta["step"] == 5 and meta["note"] == "x"
    for a, b in zip(_leaves(tree), _leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_atomicity_ignores_partial(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1))
    # a crash mid-save: a tmp dir that was never renamed
    os.makedirs(tmp_path / "step_2.tmp" / "leaves")
    assert mgr.latest_step() == 1
    # ...and a renamed dir without a manifest is ignored too
    os.makedirs(tmp_path / "step_3")
    assert mgr.latest_step() == 1


def test_checkpoint_prune_keeps_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_async_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(9, _tree(9), blocking=False)
    _wait(mgr)
    assert mgr.latest_step() == 9


def test_bf16_leaves_round_trip_bitwise(tmp_path):
    """Numpy has no bf16: a bf16 leaf is stored as its int16 view, with its
    dtype in the manifest, and comes back with the same bits (subnormals,
    infinities and NaN included)."""
    special = torch.tensor([0.0, -0.0, 1.0, -2.5, 2 ** -133, float("inf"),
                            float("-inf"), float("nan"), 3.0e38, -1e-20])
    x = torch.cat([special, torch.randn(50)]).to(torch.bfloat16)
    tree = {"params": {"blocks.0.ln1.w": x, "w": x.float()}}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, tree)
    got, meta = mgr.restore(tree)
    assert meta["dtypes"]["params__blocks.0.ln1.w"] == "bfloat16"
    restored = got["params"]["blocks.0.ln1.w"]
    assert restored.dtype == torch.bfloat16
    assert torch.equal(restored.view(torch.int16), x.view(torch.int16))
    assert torch.equal(got["params"]["w"].view(torch.int32),
                       x.float().view(torch.int32))


def test_restore_onto_a_given_device_and_dtype(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree(2)
    mgr.save(1, tree)
    meta_template = {"a": torch.empty((4, 8), device="meta"),
                     "nested": {"b": torch.empty((2, 3), dtype=torch.float32,
                                                 device="meta")},
                     "step": torch.empty((), dtype=torch.int32,
                                         device="meta")}
    got, _ = mgr.restore(meta_template, device="cpu")
    assert got["a"].device.type == "cpu" and torch.equal(got["a"], tree["a"])
    assert got["nested"]["b"].dtype == torch.float32
    assert torch.equal(got["nested"]["b"], tree["nested"]["b"].float())
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(tree)


def test_async_save_snapshots_before_an_in_place_update(tmp_path):
    """The optimizer updates in place: the state restored must be the state
    at the save, not the one the next step left."""
    mgr = CheckpointManager(str(tmp_path))
    tree = {"params": {"w": torch.randn(256, 256)},
            "opt": {"m": {"w": torch.randn(256, 256)},
                    "step": torch.tensor(4, dtype=torch.int32)}}
    want = {"w": tree["params"]["w"].clone(),
            "m": tree["opt"]["m"]["w"].clone()}
    mgr.save(4, tree, blocking=False)
    with torch.no_grad():                    # the next step, at once
        tree["params"]["w"].mul_(-3.0).add_(1.0)
        tree["opt"]["m"]["w"].zero_()
        tree["opt"]["step"].add_(1)
    _wait(mgr)
    got, meta = mgr.restore(tree)
    assert meta["step"] == 4
    assert torch.equal(got["params"]["w"], want["w"])
    assert torch.equal(got["opt"]["m"]["w"], want["m"])
    assert int(got["opt"]["step"]) == 4


def test_a_failed_async_write_is_raised_by_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1), blocking=False)
    _wait(mgr)
    # a file where the writer's tmp directory goes: its rmtree fails
    (tmp_path / "step_2.tmp").write_text("not a directory")
    mgr.save(2, _tree(2), blocking=False)
    with pytest.raises(OSError):
        _wait(mgr)
    assert mgr.latest_step() == 1
    _wait(mgr)                               # raised once
