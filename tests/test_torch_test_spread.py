"""tools/test_spread.py's port against the JAX tool.

  * ``aggregate`` on the 5 rows of artifacts/test_bounds_spread.json (the
    JAX package's spread, CPU interpret) equals the JAX tool's: the same
    stats and suggested bounds, exactly; only the workload string names
    the port's device and backend.
  * (slow) the tool itself: 5 seeds at 48x64 x 12 on the CPU, one child
    process each, printed as the table PERF.md carries beside the JAX
    anchor.
"""
import importlib.util
import json
import math
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _jax_aggregate():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_test_spread", REPO / "tools" / "test_spread.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.aggregate


def test_aggregate_equals_the_jax_tools():
    from gaus_slam_tpu_torch.tools import test_spread

    with open(REPO / "artifacts" / "test_bounds_spread.json") as f:
        anchor = json.load(f)
    rows = anchor["rows"]
    assert len(rows) == 5
    want = _jax_aggregate()(rows)
    got = test_spread.aggregate(rows, test_spread.workload("cpu", "CPU"))
    assert got["workload"] == ("synthetic 48x64 x 12 frames, CPU interpret "
                               "(tests/test_full_slam.py scale)")
    assert "NVIDIA H100 80GB HBM3 pallas" in test_spread.workload(
        "cuda", "NVIDIA H100 80GB HBM3")
    got.pop("workload")
    want.pop("workload")
    assert got == want
    # and both reproduce the anchor file's own numbers
    assert got["stats"] == anchor["stats"]
    assert got["suggested_bounds"] == anchor["suggested_bounds"]
    assert test_spread.aggregate([], "w") == {"workload": "w", "rows": []}


@pytest.mark.slow
def test_five_seeds_on_the_cpu(tmp_path):
    from gaus_slam_tpu_torch.tools import test_spread

    summary = test_spread.main(["--seeds", "0", "1", "2", "3", "4",
                                "--device", "cpu", "--out",
                                str(tmp_path / "spread.json"),
                                "--out-root", str(tmp_path)])
    assert sorted(r["seed"] for r in summary["rows"]) == [0, 1, 2, 3, 4]
    assert all(math.isfinite(v) for r in summary["rows"] for v in r.values())
    with open(REPO / "artifacts" / "test_bounds_spread.json") as f:
        anchor = json.load(f)
    print("\n| metric | port mean +- sd [min, max] | JAX anchor |")
    print("|---|---|---|")
    for k, s in summary["stats"].items():
        a = anchor["stats"][k]
        print(f"| {k} | {s['mean']:.6g} +- {s['sd']:.3g} [{s['min']:.6g}, "
              f"{s['max']:.6g}] | {a['mean']:.6g} +- {a['sd']:.3g} "
              f"[{a['min']:.6g}, {a['max']:.6g}] |")
    print("suggested bounds", json.dumps(summary["suggested_bounds"]))
