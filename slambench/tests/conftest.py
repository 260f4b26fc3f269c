"""Fixtures of the benchmark's tests: a copy of the benchmark folder with
a tiny configuration and cell that the port runs on the CPU in seconds."""
from __future__ import annotations

import copy
import json
import pprint
import runpy
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
CHECKOUT = BENCH.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

# 48x64 (the port's smallest size at which the scale cull keeps a map),
# submaps of 3 frames, few iterations
TINY_CAMERA = dict(h=48, w=64, fx=38.4, fy=38.4, cx=31.5, cy=23.5,
                   depth_scale=6553.5)
TINY_CELL = {"name": "tiny.orbit", "config": "tiny", "traffic": "orbit",
             "chips": 1, "why": "CPU test cell"}


def _tiny_config() -> dict:
    cfg = copy.deepcopy(
        runpy.run_path(str(BENCH / "configs" / "tum.py"))["CONFIG"])
    cfg["frontend"].update(num_tracking_iters=8, coarse_iters=4,
                           num_mapping_iters=4, max_frames=3,
                           tau_l=48 * 64 * 1.5)
    cfg["backend"].update(num_ba_iters=12)
    cfg["densify"]["num_addpts"] = 48 * 64
    return cfg


@pytest.fixture()
def tiny_bench(tmp_path, monkeypatch):
    """(registry, bench dict) over a copy of the benchmark folder that also
    holds configs/tiny.py and limits/tiny.orbit.json."""
    from slambench import registry

    root = tmp_path / "slambench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (root / "configs" / "tiny.py").write_text(
        '"""Tiny CPU configuration."""\nSOURCE = "test"\nREDUCED = []\n'
        f"CAMERA = {TINY_CAMERA!r}\nCONFIG = {pprint.pformat(_tiny_config())}\n")
    monkeypatch.setattr(registry, "HERE", root)
    bench = registry.benchmark(CHECKOUT / "BENCHMARK.json")
    bench["workloads"].append(dict(TINY_CELL))
    return registry, bench


def write_json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj))
