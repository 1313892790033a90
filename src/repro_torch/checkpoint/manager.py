"""Fault-tolerant checkpointing: atomic, async, self-pruning.

The counterpart of ``repro/checkpoint/manager.py`` on one process:

* **Atomic**: a checkpoint is written to ``step_N.tmp/`` and renamed to
  ``step_N/`` only after every leaf and the manifest are on disk; only
  renamed directories with a manifest count, so a process killed mid-save
  never corrupts the restore point.
* **Async, with a snapshot**: ``save(..., blocking=False)`` copies every
  tensor to host memory before it returns and writes on a background
  thread; ``wait()`` joins it (and re-raises what it raised). The port's
  optimizer updates the parameters and moments in place, so a writer that
  read device tensors while the next step ran would save a torn state.
* **Self-pruning**: keeps the newest ``keep`` checkpoints.

The layout is the port's own (ROADMAP.md, queue 3): one ``.npy`` a leaf of
a nested dict of tensors, named by its key path joined with ``__`` (the
parameters' ``state_dict`` keys, e.g. ``params__blocks.0.ln1.w``). Numpy has
no bf16, so a bf16 leaf is stored as its int16 view, with its dtype in the
manifest. ``restore`` puts each leaf on a given device (or its template's)
in its template's dtype.

**Elastic**: the leaves stay in the unsharded logical layout whatever mesh
saved them. A ``DTensor`` leaf is assembled (``launch.mesh.full_tensor``,
a collective every rank of its mesh joins) and written once, by the
process group's rank 0; a save with such leaves ends, when the files are
published (at ``wait()`` for ``blocking=False``), with a barrier, so no
rank reads a checkpoint before it is on disk. ``restore(..., mesh=,
specs=)`` gives each rank the block its spec names of every leaf
(``DTensor.from_local``): a re-shard onto any mesh, or, without them, onto
none.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.kernels.dispatch import DeviceLike
from repro_torch.launch.mesh import full_tensor

_LEAF_DIR = "leaves"
_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _flatten(tree: Any, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """``(key path, leaf)`` of a nested dict (or list/tuple) in order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _flatten(v, prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, prefix + (f"i{i}",))]
    return [("__".join(_SAFE.sub("_", p) for p in prefix) or "root", tree)]


def _unflatten(tree: Any, leaves: dict, prefix: tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves, prefix + (f"i{i}",))
                          for i, v in enumerate(tree))
    return leaves["__".join(_SAFE.sub("_", p) for p in prefix) or "root"]


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` as numpy, and its dtype's name."""
    t = torch.as_tensor(leaf).detach()
    dtype = str(t.dtype).removeprefix("torch.")
    t = t.to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy(), dtype


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier = False       # a sharded save waits for its writer

    # -- discovery ---------------------------------------------------------
    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.isfile(os.path.join(self.directory, name,
                                                 "manifest.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, metadata: Optional[dict] = None,
             blocking: bool = True) -> None:
        """Snapshot ``tree`` to host memory now; write it now or, with
        ``blocking=False``, on a background thread. ``DTensor`` leaves are
        assembled here (every rank of their mesh calls ``save``), and only
        rank 0 of the process group writes."""
        self.wait()
        flat = _flatten(tree)
        sharded = any(isinstance(leaf, DTensor) for _, leaf in flat)
        writer = not sharded or dist.get_rank() == 0
        host, dtypes = [], {}
        for key, leaf in flat:
            leaf = full_tensor(leaf)
            if writer:
                arr, dtypes[key] = _to_host(leaf)
                host.append((key, arr))
        self._barrier = sharded
        if not writer:
            if blocking:
                self.wait()
            return
        meta = dict(metadata or {})
        meta["step"] = step
        meta["leaves"] = [k for k, _ in host]
        meta["dtypes"] = dtypes

        def write():
            final = os.path.join(self.directory, f"step_{step}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(os.path.join(tmp, _LEAF_DIR))
            for key, arr in host:
                np.save(os.path.join(tmp, _LEAF_DIR, key + ".npy"), arr)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)          # atomic publish
            self._prune()

        if blocking:
            write()
            self.wait()
            return

        def run():
            try:
                write()
            except BaseException as exc:    # re-raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the background write, re-raising what it raised; after a
        sharded save, wait at a barrier for the writer."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, template: Any, step: Optional[int] = None,
                device: DeviceLike = None, mesh=None, specs: Any = None):
        """Restore into the structure of ``template`` (values ignored): each
        leaf in its template's dtype, on ``device`` or, when none is given,
        on its template's device. With ``mesh`` and ``specs`` (a tree like
        ``template`` of ``PartitionSpec``s) each leaf is a ``DTensor`` on
        the mesh's device holding this rank's block. Returns ``(tree,
        metadata)``."""
        from repro_torch.sharding.rules import shard_tensor
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        base = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(base, "manifest.json")) as f:
            meta = json.load(f)
        dtypes = meta.get("dtypes", {})
        spec_of = dict(_flatten_specs(template, specs)) if mesh is not None \
            else {}
        leaves = {}
        for key, tmpl in _flatten(template):
            t = torch.from_numpy(np.load(os.path.join(base, _LEAF_DIR,
                                                      key + ".npy")))
            if dtypes.get(key) == "bfloat16":
                t = t.view(torch.bfloat16)
            if key in spec_of:
                t = t.to(device=mesh.device_type, dtype=tmpl.dtype)
                leaves[key] = shard_tensor(t, mesh, spec_of[key])
                continue
            tmpl = torch.as_tensor(tmpl)
            where = tmpl.device if device is None else torch.device(device)
            leaves[key] = t.to(device=where, dtype=tmpl.dtype)
        return _unflatten(template, leaves), meta


def _flatten_specs(template: Any, specs: Any, prefix: tuple = ()):
    """``(key, spec)`` of each leaf of ``template``, its spec at the same
    path of ``specs`` (a ``PartitionSpec`` is a leaf there)."""
    from repro_torch.sharding.rules import PartitionSpec
    if isinstance(specs, PartitionSpec):
        for key, _ in _flatten(template, prefix):
            yield key, specs
        return
    if isinstance(template, dict):
        for k, v in template.items():
            yield from _flatten_specs(v, specs[k], prefix + (str(k),))
    elif isinstance(template, (list, tuple)):
        for i, v in enumerate(template):
            yield from _flatten_specs(v, specs[i], prefix + (f"i{i}",))
    else:
        raise ValueError(f"no spec for the leaf at {prefix}")
