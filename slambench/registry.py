"""Everything the harness finds by name: the cells of ``BENCHMARK.json``,
and for each name a file of its own under this folder:

  configs/<config>.py    CONFIG (the profile as run), CAMERA, SOURCE, REDUCED
  traffic/<traffic>.json the trajectory's parameters (reference/boxscene.py)
  metrics/<metric>.py    read(rec) -> value, or None where nothing was read
  limits/<cell>.json     the limit of each number that ``correct`` compares
  overrides/<name>.json  config groups to update: a cell's own, found by
                         its name where the file exists, or a variant's,
                         named by ``--variant`` (the precision control)

A cell, configuration, traffic mix or metric is added by adding its file
and its entry; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import runpy
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def benchmark(path: Path | None = None) -> dict:
    with open(path or CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    """The configuration module's globals (CONFIG, CAMERA, SOURCE,
    REDUCED)."""
    return runpy.run_path(str(HERE / "configs" / f"{name}.py"))


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def limits(cell_name: str) -> dict:
    with open(HERE / "limits" / f"{cell_name}.json") as f:
        return json.load(f)


def overrides(name: str, required: bool = False) -> dict:
    """overrides/<name>.json ({group: {key: value}}), or {} where there
    is none and ``required`` is false."""
    path = HERE / "overrides" / f"{name}.json"
    if not required and not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)


def reader(metric: str):
    """metrics/<metric>.py's ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "slambench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of ``cell_name`` reports: the end-to-end
    ones with --trace 0, the per-layer ones with --trace 1; an entry with
    a ``workloads`` key only in the cells it lists."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell_name in m["workloads"]]
