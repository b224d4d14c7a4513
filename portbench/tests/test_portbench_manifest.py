"""``BENCHMARK.json`` against the benchmark's rules, and a cell, a
configuration and a per-layer metric added by files alone."""

import json
import os
import re
import shutil

import pytest

from portbench import manifest, run
from portbench.tests.small import SEED, SMALL_CONFIG, SMALL_TRAFFIC

M = manifest.load()
NAME = manifest.NAME
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(M["command"]) <= 32
    assert all(LINE.match(w) for w in M["command"])
    assert not any(w.startswith("/") or ".." in w for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024


def entries():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in M[key]:
            yield key, e


@pytest.mark.parametrize("key,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})])
def test_entry_keys(key, keys):
    extra = {"workloads"} if key in ("end_to_end", "per_layer") else set()
    for e in M[key]:
        assert keys <= set(e) <= keys | extra, e


def test_names_units_and_lines():
    seen = set()
    for key, e in entries():
        assert NAME.match(e["name"]), e["name"]
        assert (key, e["name"]) not in seen
        seen.add((key, e["name"]))
        for field in ("why", "layer", "source"):
            if field in e:
                assert LINE.match(e[field]), e[field]
        if "unit" in e:
            assert manifest.UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
    for c in M["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    metric_names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_metric_sources_and_bounds():
    names = [m["name"] for m in M["end_to_end"]]
    assert "setup_s" in names and 1 <= len(names) <= 16
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert 1 <= len(M["per_layer"]) <= 128
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_cells_and_configurations():
    configs = {c["name"]: c for c in M["configs"]}
    used = {w["config"] for w in M["workloads"]}
    assert used == set(configs)
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(
        1, len(M["workloads"]) // 4)
    for w in M["workloads"]:
        assert w["chips"] in (1, 4)
        cell = manifest.cell(w["name"])
        assert cell.traffic["config"] == w["config"]
        assert cell.config["name"] == w["config"]
        assert (cell.config["source"]
                == configs[w["config"]]["source"])
        assert cell.config["reduced"] == configs[w["config"]]["reduced"]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.reader(m))
        assert callable(cell.runner().run)


def test_every_per_layer_metrics_cells_report_what_it_moves():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", sorted(cells))
        assert set(m.get("workloads", moved)) <= set(moved), m["name"]
        assert set(m.get("workloads", [])) <= cells


def test_metrics_of_follows_workloads_and_moves():
    manifest_ = {
        "end_to_end": [{"name": "setup_s"},
                       {"name": "a", "workloads": ["x"]},
                       {"name": "b", "workloads": ["y"]}],
        "per_layer": [{"name": "a.one", "moves": "a"},
                      {"name": "b.two", "moves": "b", "workloads": ["y"]},
                      {"name": "all", "moves": "setup_s"}]}
    e2e, layer = manifest.metrics_of(manifest_, "x")
    assert [m["name"] for m in e2e] == ["setup_s", "a"]
    assert [m["name"] for m in layer] == ["a.one", "all"]


def test_a_cell_configuration_and_metric_added_by_files_alone(tmp_path):
    """A copy of the benchmark's files with a new configuration, traffic
    mix, per-layer metric and manifest entries, and no file of the copy
    edited, runs through the harness."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), root)
    bench = root / "portbench"
    (bench / "configs" / "tiny.json").write_text(json.dumps(
        dict(SMALL_CONFIG, name="tiny", source="test", reduced=[])))
    (bench / "traffic" / "tiny.dirty.json").write_text(json.dumps(
        dict(SMALL_TRAFFIC, config="tiny")))
    (bench / "metrics" / "tiny.steps.py").write_text(
        "def read(trace):\n"
        "    return float(len(trace.span_seconds('dirty.step')))\n")
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "tiny", "source": "test",
                            "file": "portbench/configs/tiny.json",
                            "reduced": [], "why": "test"})
    data["workloads"].append({"name": "tiny.dirty", "config": "tiny",
                              "traffic": "tiny.dirty", "chips": 1,
                              "why": "test"})
    for m in data["end_to_end"][1:]:
        m["workloads"].append("tiny.dirty")
    data["per_layer"].append({"name": "tiny.steps", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "dirty_mvis_per_s",
                              "workloads": ["tiny.dirty"]})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    cell = manifest.cell("tiny.dirty", root=str(root))
    assert [m["name"] for m in cell.per_layer] == ["tiny.steps"]
    out = run.run_cell(cell, seed=SEED, seconds=0.3, trace=True,
                       device="cpu")
    assert out["correct"]
    assert out["metrics"]["tiny.steps"]["value"] >= 1
    assert out["metrics"]["tiny.steps"]["unit"] == "steps"
