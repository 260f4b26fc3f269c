"""The port's pipelined driver (gaus_slam_tpu_torch/scripts/gaus_mp.py)
and its frame staging against the JAX package's, on the CPU.

  * pack_frame bit-equal to the JAX package's, on random frames and on a
    frame past the 10 m uint16 ceiling.
  * The frontend's dequantization: a torch.uint16 depth tensor and the
    same numpy array give the same float32, bit-equal to the JAX
    frontend's (slam/frontend.py:55,67); uint8 colour likewise.
  * datafeeder: frame order, the "finish" sentinel, start_frame,
    stop_event, never more than 6 frames queued, and a failing dataset
    reaching the consumer.
  * The driver end to end at a tiny size (32x48 x 7, random_process off,
    save_ckpt on), then resumed from its checkpoint.
  * ``slow``: the port's gaus_mp.rgbd_slam against the JAX package's
    scripts/gaus_mp.rgbd_slam at 48x64 x 12, random_process off and
    save_ckpt on, then each resumed from its checkpoint, after
    tests/test_full_slam.py::test_gaus_mp_checkpoint_resume: both clear
    that test's bounds (PSNR > 20, resumed ATE < 0.1) and agree within
    2e-3 m ATE and 0.5 dB PSNR (the tolerance of tests/test_torch_driver.py
    for the synchronous drivers).
"""
import os
import queue
import sys
import threading
import time

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


# ---------------------------------------------------------------------------
# frame staging


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_frame_matches_jax(seed):
    from gaus_slam_tpu.utils.stage import pack_frame as j_pack
    from gaus_slam_tpu_torch.utils.stage import pack_frame as t_pack

    rng = np.random.default_rng(seed)
    color = rng.uniform(-3, 260, (24, 32, 3)).astype(np.float32)
    depth = rng.uniform(0, 9.5, (24, 32)).astype(np.float32)
    far = depth.copy()
    far[3, 5] = 10.5       # past the 10 m ceiling: depth stays float32
    for d in (depth, far):
        (jc, jd), (tc, td) = j_pack(color, d), t_pack(color, d)
        assert tc.dtype == jc.dtype == np.uint8
        assert td.dtype == jd.dtype
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(td, jd)
    assert t_pack(color, depth)[1].dtype == np.uint16
    assert t_pack(color, far)[1].dtype == np.float32


def test_dequantize_uint16_tensor_matches_jax():
    """A uint16 depth tensor dequantizes to metres, as the numpy array does
    (it once came out in counts: 6554 m for 6554 counts), bit-equal to
    the JAX frontend's dequantization."""
    import jax.numpy as jnp

    from gaus_slam_tpu.slam.frontend import _dequant_rgbd, _dequant_u16
    from gaus_slam_tpu_torch.slam.frontend import _to_device

    rng = np.random.default_rng(0)
    d16 = rng.integers(0, 65536, (24, 32)).astype(np.uint16)
    d16[0, 0] = 6554
    c8 = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
    from_np = _to_device(d16, "cpu")
    from_tensor = _to_device(torch.from_numpy(d16), "cpu")
    assert from_np.dtype == from_tensor.dtype == torch.float32
    assert torch.equal(from_np, from_tensor)
    assert abs(float(from_tensor[0, 0]) - 1.0000763) < 1e-6
    jc, jd = _dequant_rgbd(jnp.asarray(c8), jnp.asarray(d16))
    np.testing.assert_array_equal(from_tensor.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(from_np.numpy(),
                                  np.asarray(_dequant_u16(jnp.asarray(d16))))
    for c in (c8, torch.from_numpy(c8)):
        np.testing.assert_array_equal(_to_device(c, "cpu").numpy(),
                                      np.asarray(jc))


# ---------------------------------------------------------------------------
# the feeder


class _Frames:
    """A dataset of n tiny frames whose pixels carry their index."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, t):
        if t == self.fail_at:
            raise OSError(f"frame {t} unreadable")
        color = np.full((4, 6, 3), t, np.float32)
        depth = np.full((4, 6, 1), 0.5 + t / 100, np.float32)
        c2w = np.eye(4)
        c2w[0, 3] = t
        return color, depth, np.eye(3), c2w


class _Watched(queue.Queue):
    """Records the most frames ever queued at once."""

    def __init__(self):
        super().__init__()
        self.peak = 0

    def put(self, item, block=True, timeout=None):
        super().put(item, block, timeout)
        with self.mutex:
            n = sum(not isinstance(x, str) for x in self.queue)
        self.peak = max(self.peak, n)


def _feed(dataset, n, q, stop, start=0):
    from gaus_slam_tpu_torch.scripts.gaus_mp import datafeeder

    th = threading.Thread(target=datafeeder,
                          args=(dataset, n, q, stop, start, "cpu"))
    th.start()
    return th


def test_datafeeder_order_sentinel_and_backpressure():
    from gaus_slam_tpu_torch.utils.stage import DEPTH_U16_SCALE

    q, stop = _Watched(), threading.Event()
    th = _feed(_Frames(20), 20, q, stop, start=2)
    got = []
    while True:
        item = q.get(timeout=30)
        if isinstance(item, str):
            break
        got.append(item)
        time.sleep(0.01)   # a consumer slower than the feeder
    th.join(timeout=30)
    assert not th.is_alive()
    assert item == "finish" and q.empty()
    assert [g[0] for g in got] == list(range(2, 20))
    assert 1 <= q.peak <= 6
    t, color, depth, c2w, event = got[0]
    assert event is None and c2w[0, 3] == 2
    assert color.dtype == torch.uint8 and int(color[0, 0, 0]) == 2
    assert depth.dtype == torch.uint16 and depth.shape == (4, 6)
    assert int(depth[0, 0]) == round(0.52 * DEPTH_U16_SCALE)


def test_datafeeder_stop_event_and_errors():
    q, stop = queue.Queue(), threading.Event()
    th = _feed(_Frames(50), 50, q, stop)
    t0 = time.time()
    while q.qsize() < 6 and time.time() - t0 < 30:
        time.sleep(0.01)
    time.sleep(0.1)
    assert q.qsize() == 6          # held back, nothing consumed
    stop.set()
    th.join(timeout=30)
    assert not th.is_alive()
    items = [q.get() for _ in range(q.qsize())]
    assert [i[0] for i in items] == list(range(6))   # no sentinel

    q = queue.Queue()
    th = _feed(_Frames(5, fail_at=2), 5, q, threading.Event())
    th.join(timeout=30)
    items = [q.get() for _ in range(q.qsize())]
    assert [i[0] for i in items[:2]] == [0, 1]
    assert isinstance(items[2], OSError) and len(items) == 3


# ---------------------------------------------------------------------------
# the driver


def _config(env, out, load):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cfg = load(CONFIG)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    cfg["vis_base_dir"] = str(out)
    cfg["backend"]["save_ckpt"] = True
    # the pipelined loop spins far more turns than frames: no idle-time
    # random refinement (as tests/test_full_slam.py runs the JAX driver)
    cfg["backend"]["random_process"] = False
    return cfg


def test_gaus_mp_runs_and_resumes(tmp_path):
    """The driver end to end at a tiny size, then resumed from the
    checkpoint its last merge wrote."""
    import json

    from gaus_slam_tpu_torch.scripts.gaus_mp import rgbd_slam
    from gaus_slam_tpu_torch.utils.config import load_config

    r = rgbd_slam(_config(TINY, tmp_path / "run", load_config),
                  backend="interpret", device="cpu")
    for name in ("result.json", "time.json", "psnr.txt",
                 "scene/gaussians.ply", "scene/w2cs.npz.npy",
                 "ckpt/meta.json", "ckpt/arrays.npz"):
        assert (tmp_path / "run" / name).exists(), name
    for k in ("PSNR", "Depth L1", "ATE RMSE"):
        assert np.isfinite(r[k]), k
    meta = json.loads((tmp_path / "run" / "ckpt" / "meta.json").read_text())
    assert meta["next_frame_idx"] == 7 and len(meta["localmaps"]) >= 2
    r2 = rgbd_slam(_config(TINY, tmp_path / "resumed", load_config),
                   backend="interpret", device="cpu",
                   resume_from=str(tmp_path / "run" / "ckpt"))
    assert np.isfinite(r2["ATE RMSE"]) and r2["ATE RMSE"] < 0.1
    assert (tmp_path / "resumed" / "result.json").exists()


@pytest.mark.slow
def test_gaus_mp_matches_jax(tmp_path):
    """48x64 x 12 through both pipelined drivers, then resumed (several
    minutes on the CPU)."""
    sys.path.insert(0, REPO)
    from gaus_slam_tpu.utils.config import load_config as j_load
    from gaus_slam_tpu_torch.scripts.gaus_mp import rgbd_slam as t_slam
    from gaus_slam_tpu_torch.utils.config import load_config as t_load
    from scripts.gaus_mp import rgbd_slam as j_slam

    env = dict(SYN_H="48", SYN_W="64", SYN_FRAMES="12")
    jr = j_slam(_config(env, tmp_path / "j", j_load), backend="interpret")
    tr = t_slam(_config(env, tmp_path / "t", t_load), backend="interpret",
                device="cpu")
    jr2 = j_slam(_config(env, tmp_path / "j2", j_load), backend="interpret",
                 resume_from=str(tmp_path / "j" / "ckpt"))
    tr2 = t_slam(_config(env, tmp_path / "t2", t_load), backend="interpret",
                 device="cpu", resume_from=str(tmp_path / "t" / "ckpt"))
    print(f"JAX {jr['ATE RMSE']:.6g} m {jr['PSNR']:.6g} dB, resumed "
          f"{jr2['ATE RMSE']:.6g} m {jr2['PSNR']:.6g} dB; port "
          f"{tr['ATE RMSE']:.6g} m {tr['PSNR']:.6g} dB, resumed "
          f"{tr2['ATE RMSE']:.6g} m {tr2['PSNR']:.6g} dB")
    for r, r2 in ((jr, jr2), (tr, tr2)):
        assert np.isfinite(r["PSNR"]) and r["PSNR"] > 20.0, r
        assert np.isfinite(r2["ATE RMSE"]) and r2["ATE RMSE"] < 0.1, r2
        assert np.isfinite(r2["PSNR"])
    assert abs(tr["ATE RMSE"] - jr["ATE RMSE"]) < 2e-3
    assert abs(tr["PSNR"] - jr["PSNR"]) < 0.5
    assert abs(tr2["ATE RMSE"] - jr2["ATE RMSE"]) < 2e-3
    assert abs(tr2["PSNR"] - jr2["PSNR"]) < 0.5
