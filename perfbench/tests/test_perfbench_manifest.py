"""``BENCHMARK.json`` resolves by name to files of their own, keeps to the
benchmark's contract, and takes a new configuration, traffic mix and
metric without an edit of any file that is there."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import harness, manifest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench_json():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keeps_to_the_contract():
    b = bench_json()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and 1 <= b["run_seconds"] <= 51
    assert b["command"][1] == "perfbench/run.py"
    configs = {c["name"]: c for c in b["configs"]}
    cells = {w["name"]: w for w in b["workloads"]}
    assert {w["config"] for w in b["workloads"]} == set(configs)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["reduced"] == c["reduced"] == []
        assert config["source"] == c["source"] and c["file"].startswith(
            "perfbench/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert set(m["workloads"]) <= set(cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for name in list(configs) + list(cells):
        assert NAME.match(name)


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      bench_json()["workloads"]])
def test_each_cell_resolves_by_name(workload):
    cell = manifest.resolve(bench_json(), workload)
    assert cell.name == workload
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "study_s"}
    assert cell.per_layer
    for call in cell.calls:
        assert callable(cell.entry(call).call)
        assert callable(cell.work(call).count)
    assert any(cell.reference(c) for c in cell.calls)
    for metric in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(metric["name"]).read)


def test_an_unknown_name_is_refused():
    with pytest.raises(manifest.ManifestError):
        manifest.resolve(bench_json(), "no-such.cell")
    with pytest.raises(manifest.ManifestError):
        manifest.load_module(BENCH / "metrics" / "no_such_metric.py")


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def test_an_addition_edits_no_existing_file(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path / "perfbench")
    bench = tmp_path / "perfbench"
    # a configuration, a mix, its limits and a metric, each a new file
    config = json.loads((bench / "configs" / "square-16k.json").read_text())
    config.update(name="square-small", n=32)
    (bench / "configs" / "square-small.json").write_text(json.dumps(config))
    mix = json.loads((bench / "traffic" / "study.json").read_text())
    mix["calls"][2]["args"]["permutations"] = 99
    (bench / "traffic" / "study-k99.json").write_text(json.dumps(mix))
    limits = json.loads((bench / "limits" / "square-16k.study.json")
                        .read_text())
    (bench / "limits" / "square-small.study-k99.json").write_text(
        json.dumps(limits))
    (bench / "metrics" / "validate_s.study.py").write_text(
        "def read(run):\n"
        "    return run.call_s('validate')\n")
    b = bench_json()
    b["configs"].append({"name": "square-small", "source": "test",
                         "file": "perfbench/configs/square-small.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "square-small.study-k99",
                           "config": "square-small", "traffic": "study-k99",
                           "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "validate_s.study", "unit": "s",
                           "better": "lower", "source": "host_clock",
                           "layer": "entry points", "moves": "study_s",
                           "workloads": ["square-small.study-k99"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    result = harness.run_cell(tmp_path, "square-small.study-k99", 7, 0.2,
                              True, "cpu")
    assert result["correct"]
    assert "validate_s.study" in result["metrics"]
    after = digest(bench)
    assert {k: after[k] for k in before} == before
