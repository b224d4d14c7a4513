"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by name:

- a configuration: the file its ``configs`` entry names;
- a traffic mix: ``traffic/<cell>.json``, which names the runner
  (``runners/<runner>.py``) and its parameters;
- a per-layer metric: ``metrics/<metric>.py``, a module with
  ``read(trace) -> float | None``.

So a cell, a configuration or a per-layer metric is added with new files
and manifest entries, and no file that exists changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import re

#: The benchmark's own directory and the checkout's root.
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list   # manifest entries of the metrics it reports
    per_layer: list
    bench_dir: str

    def runner(self):
        return importlib.import_module(
            f"portbench.runners.{self.traffic["runner"]}")

    def reader(self, metric: dict):
        """The ``read`` function of a per-layer metric's module."""
        path = os.path.join(self.bench_dir, "metrics", f"{metric['name']}.py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + re.sub(r"\W", "_", metric["name"]), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def metrics_of(manifest: dict, workload: str) -> tuple:
    """(end-to-end, per-layer) metric entries that ``workload`` reports: a
    metric with ``workloads`` where it lists the cell; an end-to-end one
    without, everywhere; a per-layer one without, wherever the end-to-end
    metric it moves is reported."""
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def cell(workload: str, root: str = ROOT) -> Cell:
    """The manifest's cell ``workload``, with its configuration's and
    traffic mix's files read."""
    manifest = load(root)
    entry = {w["name"]: w for w in manifest["workloads"]}.get(workload)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = {c["name"]: c for c in manifest["configs"]}[entry["config"]]
    with open(os.path.join(root, config["file"])) as f:
        config_data = json.load(f)
    bench_dir = os.path.join(root, manifest["paths"][0])
    with open(os.path.join(bench_dir, "traffic", f"{workload}.json")) as f:
        traffic = json.load(f)
    if traffic.get("config") != entry["config"]:
        raise ValueError(f"traffic/{workload}.json is for configuration "
                         f"{traffic.get('config')!r}, the manifest says "
                         f"{entry['config']!r}")
    e2e, layer = metrics_of(manifest, workload)
    return Cell(workload, entry["chips"], config_data, traffic, e2e, layer,
                bench_dir)
