"""The port's driver (gaus_slam_tpu_torch/scripts/gaus.py) against the
JAX package's (scripts/gaus.py), both from configs/synthetic/config.py.

  * A tiny schedule (32x48, 7 frames, submaps of 3 frames, 6 tracking,
    4 mapping and 4 backend iterations): the same number of submaps,
    merges and backend tasks of each kind; the port's artifacts exist,
    its metrics are finite, and ATE and PSNR lie within 2e-3 m and
    0.5 dB of the JAX run's. The packages part by rounding (ROADMAP queue
    3: 0.06 mm after one frame, 0.76 mm by frame 5 at 48x64), and 2e-3 m
    is about three times the drift measured by frame 5. At this size the
    scale cull (scale_max 0.1) prunes every merged surfel in both
    packages, so PSNR is that of an empty render in both.
  * ``slow``: the port's driver at 48x64 over 12 frames clears the bounds
    tests/test_full_slam.py:37-40 holds the JAX system to.
  * The reference render backend (the plain compositor with K5's plain
    version) through the port's driver on a short run.
"""
import collections
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(REPO, "configs", "synthetic", "config.py")
TINY = dict(SYN_H="32", SYN_W="48", SYN_FRAMES="7", SYN_MAX_FRAMES="3",
            SYN_TRACK_ITERS="6", SYN_MAP_ITERS="4", SYN_BA_ITERS="4")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(env, out):
    from gaus_slam_tpu_torch.utils.config import load_config

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cfg = load_config(CONFIG)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    cfg["vis_base_dir"] = str(out)
    return cfg


def _count_backend(monkeypatch, backend_cls):
    """Counts merges and tasks by kind (the queue head when process() is
    called; "idle" on an empty queue) of every Backend of ``backend_cls``."""
    seen = {"merges": 0, "tasks": collections.Counter(), "backend": None}
    merge, process = backend_cls.process_localmap, backend_cls.process

    def process_localmap(be, lm, multi_process=False):
        seen["merges"] += 1
        seen["backend"] = be
        return merge(be, lm, multi_process)

    def process_(be):
        q = be.task_queue
        items = q.queue if hasattr(q, "queue") else q
        seen["tasks"][items[0][0] if items else "idle"] += 1
        return process(be)

    monkeypatch.setattr(backend_cls, "process_localmap", process_localmap)
    monkeypatch.setattr(backend_cls, "process", process_)
    return seen


def test_tiny_schedule_matches_jax(tmp_path, monkeypatch):
    sys.path.insert(0, REPO)
    from gaus_slam_tpu.slam.backend import Backend as JBackend
    from gaus_slam_tpu_torch.scripts.gaus import rgbd_slam as t_slam
    from gaus_slam_tpu_torch.slam.backend import Backend as TBackend
    from scripts.gaus import rgbd_slam as j_slam

    jseen = _count_backend(monkeypatch, JBackend)
    tseen = _count_backend(monkeypatch, TBackend)
    jr = j_slam(_config(TINY, tmp_path / "j"), backend="interpret")
    tr = t_slam(_config(TINY, tmp_path / "t"), backend="interpret",
                device="cpu")
    jb, tb = jseen["backend"], tseen["backend"]
    assert len(tb.local_maps) == len(jb.local_maps) >= 2
    assert tseen["merges"] == jseen["merges"] >= 2
    assert tseen["tasks"] == jseen["tasks"]
    assert {"mapping", "prune", "tracking"} <= set(tseen["tasks"])
    for name in ("result.json", "time.json", "psnr.txt", "l1.txt",
                 "scene/gaussians.ply", "scene/w2cs.npz.npy",
                 "scene/gt_w2cs.npz.npy", "scene/config.json"):
        assert (tmp_path / "t" / name).exists(), name
    for k in ("PSNR", "MS-SSIM", "Depth RMSE", "Depth L1", "ATE RMSE"):
        assert np.isfinite(tr[k]), k
    assert list(tr) == list(jr)
    assert abs(tr["ATE RMSE"] - jr["ATE RMSE"]) < 2e-3
    assert abs(tr["PSNR"] - jr["PSNR"]) < 0.5
    assert tr["num_gaussians"] == jr["num_gaussians"]


@pytest.mark.slow
def test_driver_clears_the_full_slam_bounds(tmp_path):
    """48x64 over 12 frames, as tests/test_full_slam.py runs the JAX
    driver (about 3 minutes on the CPU)."""
    from gaus_slam_tpu_torch.scripts.gaus import rgbd_slam

    r = rgbd_slam(_config(dict(SYN_H="48", SYN_W="64", SYN_FRAMES="12"),
                          tmp_path), backend="interpret", device="cpu")
    assert r["ATE RMSE"] < 0.025, r
    assert r["PSNR"] > 25.1, r
    assert np.isfinite(r["MS-SSIM"]) and r["MS-SSIM"] > 0.99
    assert r["Depth L1"] < 0.017
    for name in ("result.json", "time.json", "scene/gaussians.ply",
                 "scene/w2cs.npz.npy"):
        assert (tmp_path / name).exists(), name


def test_driver_under_the_reference_backend(tmp_path, monkeypatch):
    """The command line, --backend reference --device cpu: every render
    through the plain compositor, every backward through K5's plain
    version. That backend renders whole frames only, so mapping runs at
    coarse stride 1 (COARSE_MAP_STRIDE), as chip_smoke's phase 3b does."""
    from gaus_slam_tpu_torch.ops import raster_backward
    from gaus_slam_tpu_torch.scripts import gaus

    calls = collections.Counter()
    plain = raster_backward.raster_backward_plain

    def counted(*a, **kw):
        calls["raster_backward_plain"] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(raster_backward, "raster_backward_plain", counted)
    env = dict(TINY, SYN_FRAMES="4", SYN_OUT=str(tmp_path),
               COARSE_MAP_STRIDE="1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    r = gaus.main([CONFIG, "--backend", "reference", "--device", "cpu"])
    assert calls["raster_backward_plain"] > 0
    for k in ("PSNR", "MS-SSIM", "Depth L1", "ATE RMSE"):
        assert np.isfinite(r[k]), k
    assert (tmp_path / "result.json").exists()
    assert (tmp_path / "scene" / "gaussians.ply").exists()


def test_driver_refuses_what_it_cannot_run(monkeypatch, tmp_path):
    """No silent CPU fallback without a card; an unknown dataset name
    raises ValueError, and "replica" without its directory tree raises the
    loader's error."""
    from gaus_slam_tpu_torch.data import get_dataset
    from gaus_slam_tpu_torch.scripts.gaus import rgbd_slam

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rgbd_slam(_config(TINY, "unused"), device="cuda")
    with pytest.raises(ValueError, match="Unknown dataset"):
        get_dataset({"dataset_name": "kitti", "basedir": "", "sequence": ""})
    with pytest.raises(FileNotFoundError, match="traj.txt"):
        get_dataset({"dataset_name": "replica", "basedir": str(tmp_path),
                     "sequence": "room0"})
