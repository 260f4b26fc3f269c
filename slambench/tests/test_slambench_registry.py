"""The harness finds cells, configurations, traffic mixes, metrics and
limits by name, so that one added as files is picked up without an edit;
and BENCHMARK.json keeps to the names and units the contract allows."""
from __future__ import annotations

import json
import re

import pytest

from conftest import CHECKOUT, write_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_new_files_are_found_by_name(tiny_bench):
    registry, bench = tiny_bench
    root = registry.HERE
    write_json(root / "traffic" / "still.json",
               {"frames_per_pass": 20, "t_span": 0.0169, "orbit": {}})
    (root / "metrics" / "frontend.frames.py").write_text(
        "def read(rec):\n    return rec.get('frames')\n")
    write_json(root / "limits" / "tiny.still.json", {"track_err_mm": 5.0})
    write_json(root / "overrides" / "tiny.still.json",
               {"tpu": {"backend_device": "auto"}})
    bench["workloads"].append({"name": "tiny.still", "config": "tiny",
                               "traffic": "still", "chips": 1, "why": "x"})
    bench["per_layer"].append({
        "name": "frontend.frames", "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "frontend", "moves": "fps",
        "workloads": ["tiny.still"]})

    assert registry.cell(bench, "tiny.still")["traffic"] == "still"
    assert registry.config("tiny")["CAMERA"]["w"] == 64
    assert registry.traffic("still")["frames_per_pass"] == 20
    assert registry.limits("tiny.still") == {"track_err_mm": 5.0}
    assert registry.overrides("tiny.still") == {
        "tpu": {"backend_device": "auto"}}
    assert registry.overrides("tiny.orbit") == {}
    with pytest.raises(FileNotFoundError):
        registry.overrides("tiny.nothing", required=True)
    assert registry.reader("frontend.frames")({"frames": 7}) == 7
    names = [m["name"] for m in registry.metrics_for(bench, "tiny.still", True)]
    assert "frontend.frames" in names and "kernel.k1_roofline" in names
    names = [m["name"] for m in registry.metrics_for(bench, "tiny.orbit", True)]
    assert "frontend.frames" not in names
    with pytest.raises(KeyError):
        registry.cell(bench, "tiny.nothing")


def test_overrides_are_data_applied_in_order():
    from slambench import harness, registry

    assert registry.overrides("bf16", required=True) == {
        "tpu": {"compute_dtype": "bf16"}}
    cell = {"tpu": {"compute_dtype": "bf16", "backend_device": "auto"}}
    assert harness._merge(cell, None, {"tpu": {"compute_dtype": "f32"},
                                       "frontend": {"max_frames": 3}}) == {
        "tpu": {"compute_dtype": "f32", "backend_device": "auto"},
        "frontend": {"max_frames": 3}}


def test_every_metric_has_a_reader_and_every_cell_its_files():
    from slambench import registry

    bench = registry.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.reader(m["name"]))
        assert registry.reader(m["name"])({}) is None
    for w in bench["workloads"]:
        assert set(registry.config(w["config"])) >= {"CONFIG", "CAMERA",
                                                      "SOURCE", "REDUCED"}
        assert registry.traffic(w["traffic"])["frames_per_pass"] > 1
        assert registry.limits(w["name"])


def test_benchmark_json_names_and_units():
    with open(CHECKOUT / "BENCHMARK.json") as f:
        bench = json.load(f)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in bench[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for c in bench["configs"]:
        assert c["file"].startswith("slambench/configs/")
        assert c["reduced"] == registry_reduced(c["name"])


def registry_reduced(name):
    from slambench import registry

    return registry.config(name)["REDUCED"]
