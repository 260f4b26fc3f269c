"""A whole run of the tiny cell on the CPU drives the harness from set-up
to the result line; the fault runs (faults.py) plant their faults where
the timed path calls them. Whether each fault turns ``correct`` false is
tested on the card, at the cells' own sizes (test_slambench_cuda.py):
at 48x64 the sound program's own errors are as large as the faults'."""
from __future__ import annotations

import time

import pytest

from conftest import write_json

# the tiny cell's limits: a smoke test of the harness, not a yardstick
TINY_LIMITS = {"track_err_mm": 200.0, "front_mse": 0.05, "global_mse": 0.2}


def test_tiny_run_drives_the_whole_harness(tiny_bench):
    registry, bench = tiny_bench
    write_json(registry.HERE / "limits" / "tiny.orbit.json", TINY_LIMITS)
    from slambench import harness

    result, lines = harness.run_cell(bench, "tiny.orbit", 1, 6.0, False,
                                     t_start=time.perf_counter(),
                                     device="cpu")
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    # no card: no peak memory to read
    assert set(result["metrics"]) == {"fps", "setup_s"}
    assert list(result)[-1] == "compared"
    assert set(result["compared"]) == set(TINY_LIMITS)
    assert lines[-1].startswith("compared ")
    assert any(line.startswith("[slambench] number merged_uncovered_median ")
               for line in lines)
    assert result["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                                "memory_peak_bytes": 0}


@pytest.mark.parametrize("fault, module, names", [
    ("tracking_unchanged", "frontend", ("tracking_loop",)),
    ("pose_altered", "frontend", ("tracking_loop",)),
    ("front_map_unchanged", "frontend", ("mapping_loop", "mapping_step")),
    ("back_map_unchanged", "backend", ("mapping_loop", "mapping_step")),
    ("ba_unchanged", "backend", ("backend_tracking_step",)),
])
def test_faults_are_planted_where_the_window_calls(fault, module, names,
                                                   monkeypatch):
    import importlib

    import faults

    mod = importlib.import_module(f"gaus_slam_tpu_torch.slam.{module}")
    for name in names:
        monkeypatch.setattr(mod, name, getattr(mod, name))
    before = {n: getattr(mod, n) for n in names}
    faults.FAULTS[fault]()
    assert all(getattr(mod, n) is not before[n] for n in names)
