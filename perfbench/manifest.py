"""Find everything a cell needs by the names in ``BENCHMARK.json``.

Nothing here names a cell, a configuration, a traffic mix or a metric: each
is a file of its own, found by name, so a later change adds a cell by adding
files and entries and edits none that is there.

* ``configs/<name>.json`` — a configuration: its sizes, guarantees, source,
  ``assumed`` and ``reduced``, and ``inputs``, the maker of its inputs;
* ``inputs/<kind>.py`` — ``make(config, plan, device) -> dict`` of tensors;
* ``traffic/<name>.json`` — a mix: the calls of one study, each naming an
  entry and its arguments (``perfbench.traffic`` reads it);
* ``entries/<entry>.py`` — ``call(inputs, args, key, device, state)``: one
  call into the port; an entry with ``summary(outputs)`` keeps only that
  of every study but the window's last;
* ``work/<entry>.py`` — ``count(inputs, args)``: the operations and bytes
  the call's algorithm needs, from shapes;
* ``reference/<entry>.py`` — ``judge(name, inputs, args, studies, rng,
  limits, control)``: the plain reference's readings of what the window
  produced (an entry without one is judged by a later call's reference);
* ``limits/<workload>.json`` — each reading's limit in that cell;
* ``metrics/<metric>.py`` — ``read(run)``: one metric, or None where the
  run has nothing to read for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import zlib
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parent


class ManifestError(ValueError):
    """A name in ``BENCHMARK.json`` or a traffic file that resolves to no
    file, or a file that lacks what the harness reads from it."""


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise ManifestError(f"missing {path}")
    return json.loads(path.read_text())


def load_module(path: Path) -> ModuleType:
    """Import ``path`` as a module of its own (names may hold dots)."""
    if not path.is_file():
        raise ManifestError(f"missing {path}")
    path = path.resolve()
    stem = "_".join(path.relative_to(path.parents[1]).with_suffix("").parts)
    name = (f"perfbench_{zlib.crc32(str(path).encode()):08x}_"
            + stem.replace(".", "_").replace("-", "_"))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Call:
    """One call of a study: its span name, entry and arguments."""

    name: str
    entry: str
    args: dict


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    calls: list
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path = BENCH

    @property
    def name(self) -> str:
        return self.workload["name"]

    def inputs(self):
        return load_module(self.root / "inputs" / f"{self.config['inputs']}.py")

    def entry(self, call: Call):
        return load_module(self.root / "entries" / f"{call.entry}.py")

    def work(self, call: Call):
        return load_module(self.root / "work" / f"{call.entry}.py")

    def reference(self, call: Call):
        """The call's reference module, or None where the call's outputs
        are judged by a later call's reference."""
        path = self.root / "reference" / f"{call.entry}.py"
        return load_module(path) if path.is_file() else None

    def reader(self, metric: str):
        return load_module(self.root / "metrics" / f"{metric}.py")


def reported_in(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(manifest: dict, workload: str, root: Path = BENCH) -> Cell:
    """The cell named ``workload`` with every file it names loaded."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise ManifestError(f"no workload {workload!r} in BENCHMARK.json; "
                            f"known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    if cell["config"] not in configs:
        raise ManifestError(f"workload {workload!r} names no known config")
    entry = configs[cell["config"]]
    config = load_json(root.parent / entry["file"])
    traffic = load_json(root / "traffic" / f"{cell['traffic']}.json")
    calls = [Call(c["name"], c["entry"], dict(c.get("args", {})))
             for c in traffic["calls"]]
    limits = load_json(root / "limits" / f"{workload}.json")["limits"]
    out = Cell(cell, config, traffic, calls, limits,
               [m for m in manifest["end_to_end"] if reported_in(m, workload)],
               [m for m in manifest["per_layer"] if reported_in(m, workload)],
               root)
    out.inputs()
    for call in calls:
        out.entry(call)
        out.work(call)
        out.reference(call)
    for metric in out.end_to_end + out.per_layer:
        out.reader(metric["name"])
    return out
