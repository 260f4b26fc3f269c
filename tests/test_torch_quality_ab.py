"""tools/quality_ab.py and tools/ab_runner.py's ports against the JAX tools.

  * VARIANTS equal the JAX tool's (loaded from its file: it imports no
    jax at module level).
  * On one rows file, --summarize-only prints the JAX tool's table byte
    for byte (both tools in child processes), and writes nothing.
  * A sweep skips the (seed, variant) pairs already in --out.
  * ab_runner on the CPU at 48x64 x 4 frames (submaps of 2 frames, a cut
    schedule of iterations so that the seeds part): seed 1's row is the
    same whether seed 1 runs alone or after seed 0 in one process; with
    GAUS_LAUNCH_LOG set each child appends its launch counts as it exits.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_variants_equal_the_jax_tools():
    from gaus_slam_tpu_torch.tools import quality_ab

    jax_variants = _jax_tool("quality_ab").VARIANTS
    assert quality_ab.VARIANTS == jax_variants
    assert list(quality_ab.VARIANTS) == list(jax_variants)
    assert len(quality_ab.VARIANTS) == 29


def _rows():
    """The JAX anchor's rows plus rows of the other cases the table has:
    a second variant within budget, one outside it, one with a single
    seed, one failed seed."""
    with open(REPO / "artifacts" / "quality_ab_r5.jsonl") as f:
        rows = [json.loads(line) for line in f if line.strip()]
    rows += [
        {"seed": 0, "variant": "coarse0", "wall_s": 60.2, "psnr": 38.9,
         "ate_rmse": 0.0049, "ssim": 0.95, "depth_l1": 0.005},
        {"seed": 1, "variant": "coarse0", "wall_s": 61.0, "psnr": 38.7,
         "ate_rmse": 0.0052, "ssim": 0.95, "depth_l1": 0.005},
        {"seed": 0, "variant": "rebin1", "wall_s": 70.5, "psnr": 38.95,
         "ate_rmse": 0.0051, "ssim": 0.95, "depth_l1": 0.005},
        {"seed": 1, "variant": "rebin1", "error": "RuntimeError('x')",
         "wall_s": 3.0},
    ]
    return rows


def test_summary_table_is_the_jax_tools(tmp_path):
    out = tmp_path / "rows.jsonl"
    text = "".join(json.dumps(r) + "\n" for r in _rows())
    out.write_text(text)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    args = ["--summarize-only", "--out", str(out)]
    jax = subprocess.run([sys.executable, str(REPO / "tools" /
                                              "quality_ab.py"), *args],
                         cwd=REPO, env=env, capture_output=True, timeout=120)
    port = subprocess.run([sys.executable, "-m",
                           "gaus_slam_tpu_torch.tools.quality_ab", *args],
                          cwd=REPO, env=env, capture_output=True,
                          timeout=120)
    assert jax.returncode == 0 and port.returncode == 0, port.stderr
    assert port.stdout == jax.stdout
    table = port.stdout.decode()
    assert "| default | 38.64 +- 0.57 | 0.0051 +- 0.0006 |" in table
    assert "| coarse0 |" in table and "| yes |" in table
    assert "| cmapb3pp |" in table and "| NO |" in table
    assert "| refshape | failed | failed | - | 0 | - |" in table
    assert out.read_text() == text        # nothing written


def test_resume_skips_done_pairs(tmp_path, monkeypatch, capsys):
    from gaus_slam_tpu_torch.tools import quality_ab

    out = tmp_path / "rows.jsonl"
    done = [{"seed": 0, "variant": "default", "psnr": 38.0,
             "ate_rmse": 0.005, "wall_s": 1.0},
            {"seed": 1, "variant": "default", "error": "x", "wall_s": 1.0},
            {"seed": 0, "variant": "coarse0", "psnr": 38.1,
             "ate_rmse": 0.005, "wall_s": 1.0}]
    out.write_text("".join(json.dumps(r) + "\n" for r in done))
    calls = []

    def fake_run_variant(variant, seeds, frames, h, w, on_row, device,
                         out_root):
        calls.append((variant, list(seeds), frames, h, w, device))
        for s in seeds:
            on_row({"seed": s, "variant": variant, "psnr": 37.0 + s,
                    "ate_rmse": 0.006, "wall_s": 2.0})
        return 0

    monkeypatch.setattr(quality_ab, "run_variant", fake_run_variant)
    rows = quality_ab.main(["--seeds", "0", "1", "--variants", "default",
                            "coarse0", "--frames", "5", "--device", "cpu",
                            "--out", str(out)])
    # variant-major; a failed seed runs again, a done one does not
    assert calls == [("default", [1], 5, 340, 600, "cpu"),
                     ("coarse0", [1], 5, 340, 600, "cpu")]
    assert [json.loads(line) for line in out.read_text().splitlines()] \
        == rows
    assert len(rows) == 5
    assert "| coarse0 |" in capsys.readouterr().out
    # a second pass has nothing left to run
    calls.clear()
    quality_ab.main(["--seeds", "0", "1", "--variants", "default",
                     "coarse0", "--device", "cpu", "--out", str(out)])
    assert calls == []


def test_unknown_variant_is_refused(tmp_path):
    from gaus_slam_tpu_torch.tools import quality_ab

    with pytest.raises(SystemExit):
        quality_ab.main(["--variants", "nope", "--device", "cpu", "--out",
                         str(tmp_path / "rows.jsonl")])


TINY = ["--frames", "4", "--height", "48", "--width", "64", "--device",
        "cpu", "--env", json.dumps({"SYN_TRACK_ITERS": "6",
                                    "SYN_MAP_ITERS": "4",
                                    "SYN_BA_ITERS": "2",
                                    "SYN_MAX_FRAMES": "2"})]


def test_a_seeds_row_does_not_depend_on_the_seeds_before_it(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2",
               MESH_DEVICES="off")

    def start(seeds, root):
        return subprocess.Popen(
            [sys.executable, "-m", "gaus_slam_tpu_torch.tools.ab_runner",
             "--variant", "default", "--seeds", *seeds, *TINY,
             "--out-root", str(tmp_path / root)],
            cwd=REPO, env=dict(env, GAUS_LAUNCH_LOG=str(tmp_path / root)
                               + ".launches"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    both, alone = start(["0", "1"], "both"), start(["1"], "alone")
    rows = {}
    for key, proc in (("both", both), ("alone", alone)):
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-2000:]
        rows[key] = [json.loads(line[len("ABROW "):])
                     for line in out.splitlines() if line.startswith("ABROW ")]
    assert [r["seed"] for r in rows["both"]] == [0, 1]
    for r in rows["both"] + rows["alone"]:
        assert "error" not in r, r
        assert set(r) == {"seed", "variant", "wall_s", "psnr", "ate_rmse",
                          "ssim", "depth_l1"}
        r.pop("wall_s")
    assert rows["both"][1] == rows["alone"][0]
    # the seeds part on this schedule, so the check can see a carry-over
    assert rows["both"][0]["psnr"] != rows["both"][1]["psnr"]
    assert os.path.exists(tmp_path / "alone" / "ab_default_s1" /
                          "result.json")
    # each child appended its kernel launch counts as it exited: none on
    # the CPU, where the wrappers run the plain versions
    for root, proc in (("both", both), ("alone", alone)):
        lines = (tmp_path / f"{root}.launches").read_text().splitlines()
        assert [json.loads(line) for line in lines] == [
            {"pid": proc.pid, "launches": {}}]
