"""The readers of the program's spans and device intervals (metrics/
programs.busy_share.py, frontend.device_ms_per_frame.py,
frontend.track_ms_per_iter.py, frontend.host_ms_per_frame.py,
backend.device_ms_per_frame.py, programs.capture_ms_per_frame.py): None
on an empty record, and on a record set put into the program's tracing
module the values worked out by hand."""
from __future__ import annotations

import json

import pytest

from conftest import CHECKOUT

MS = 1_000_000
T0 = 5_000 * MS          # the traced part: 5.000 s to 5.400 s
READERS = {
    # the union 12-45, 260-290 (the shard's inside), 390-400 (cut at the
    # window's end) over 400 ms
    "programs.busy_share": 100.0 * (33 + 30 + 10) / 400,
    # frontend owner: 28 + 15 ms over two frames
    "frontend.device_ms_per_frame": (28 + 15) / 2,
    # tracking_loop: 28 ms over 40 + 30 iterations
    "frontend.track_ms_per_iter": 28 / 70,
    # frames 200 ms, waits 8 + 2 + 4 ms (the nested wait once)
    "frontend.host_ms_per_frame": (200 - 14) / 2,
    # backend 30 + 30 (a launch that starts inside counts whole; only the
    # union is cut at the window's end) and its shard 5, over two frames
    "backend.device_ms_per_frame": (30 + 30 + 5) / 2,
    "programs.capture_ms_per_frame": 30 / 2,
}


def _span(i, name, t0, t1, parent=None, **attrs):
    return {"id": i, "name": name, "parent": parent, "thread": 1,
            "t0_ns": T0 + t0 * MS, "t1_ns": T0 + t1 * MS, "attrs": attrs}


def _iv(owner, program, t0, t1, span=None):
    return {"owner": owner, "program": program, "device": "cuda:0",
            "span": span, "thread": 1, "t0_ns": T0 + t0 * MS,
            "t1_ns": T0 + t1 * MS}


@pytest.fixture()
def traced(monkeypatch):
    """The tracing module holding a hand-made record set; the run's
    record of the traced part."""
    from gaus_slam_tpu_torch.utils import trace

    spans = [
        _span(1, trace.FRAME, 0, 100, frame=0, kind="tracked"),
        _span(2, trace.TRACKING, 10, 60, parent=1, iters=40),
        _span(3, "frontend.wait", 50, 58, parent=2),
        _span(4, "frontend.wait", 70, 72, parent=1),
        _span(5, trace.FRAME, 200, 300, frame=1, kind="cut"),
        _span(6, "frontend.wait", 210, 214, parent=5),
        _span(7, "frontend.wait", 211, 213, parent=6),
        _span(8, trace.CAPTURE, 220, 250, parent=5, owner="frontend",
              program="mapping_loop"),
        _span(10, trace.TRACKING, 205, 209, parent=5, iters=30),
        # before and after the traced part: left out
        _span(11, trace.FRAME, -100, -10, frame=-1, kind="tracked"),
        _span(9, trace.FRAME, 500, 600, frame=2, kind="tracked"),
        _span(12, trace.CAPTURE, 510, 550, parent=9, owner="backend",
              program="prune"),
    ]
    ivs = [_iv("frontend", "tracking_loop", 12, 40, span=2),
           _iv("frontend", "mapping_loop", 30, 45, span=1),
           _iv("backend", "mapping_loop", 260, 290),
           _iv("backend-shard1", "ba_shard", 262, 267),
           _iv("backend", "prune_gaussians", 390, 420),
           _iv("frontend", "tracking_loop", -50, -20),
           _iv("frontend", "tracking_loop", 510, 520, span=9)]
    monkeypatch.setattr(trace, "_SPANS", spans)
    monkeypatch.setattr(trace, "_IVS", ivs)
    monkeypatch.setattr(trace, "_PENDING", [])
    return {"prof_t0": T0 / 1e9, "traced_s": 0.4, "frames": 3,
            "traced": True}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_none_on_an_empty_record(name):
    from slambench import registry

    assert registry.reader(name)({}) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_by_hand(traced, name):
    from slambench import registry

    assert registry.reader(name)(traced) == pytest.approx(READERS[name],
                                                          rel=1e-9)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_none_where_nothing_was_traced(monkeypatch, name):
    from gaus_slam_tpu_torch.utils import trace
    from slambench import registry

    for attr in ("_SPANS", "_IVS", "_PENDING"):
        monkeypatch.setattr(trace, attr, [])
    assert registry.reader(name)({"prof_t0": 1.0, "traced_s": 20.0}) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_none_on_a_program_without_tracing(monkeypatch, traced,
                                                      name):
    """The parent of the tracing module: the import fails, nothing raises."""
    import sys

    import gaus_slam_tpu_torch.utils as utils
    from slambench import registry

    monkeypatch.setitem(sys.modules, "gaus_slam_tpu_torch.utils.trace", None)
    monkeypatch.delattr(utils, "trace")
    assert registry.reader(name)(traced) is None


def test_the_six_entries_in_benchmark_json():
    with open(CHECKOUT / "BENCHMARK.json") as f:
        bench = json.load(f)
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert set(READERS) <= set(entries)
    for name in READERS:
        m = entries[name]
        assert m["source"] == "program_counter" and m["moves"] == "fps"
        assert m["workloads"] == ["tum.handheld"]
    assert entries["programs.busy_share"]["unit"] == "%"
    assert entries["frontend.track_ms_per_iter"]["unit"] == "ms/iter"
