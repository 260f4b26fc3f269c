"""The port's checkpoints against the JAX package's, at 48x64.

The run state is built by hand in the JAX package (a frontend map and a
backend map with numpy-seeded Adam moments, two live frames, two merged
submaps with transforms and, for one, an exposure) and carried into the
port by convert.py.

  * A port round trip restores every tensor bit for bit: both maps with
    Adam m / v / step, the submaps' transforms and exposures, the frame
    cursor, the live frames and the kept keyframes' images (reloaded from
    the dataset by time_idx).
  * On the same state the port's meta.json has the JAX package's keys and
    values (the JAX side written with orbax), and arrays.npz holds the
    JAX checkpoint's arrays under the same tree paths.
  * ``convert.run_state_from_jax`` applied to the JAX checkpoint equals
    the port's restore of its own checkpoint.
  * (slow) The port driver at 48x64 x 12 frames on the CPU with
    backend.save_ckpt, then resumed from the checkpoint: held to what
    tests/test_full_slam.py holds the JAX driver to.
"""
import json
import os
import queue

import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch import convert
from gaus_slam_tpu_torch.models.gaussians import PARAM_FIELDS
from test_torch_backend import _config, _dataset, _scene, _submap


def _seeded_map(gm, rng):
    """A JAX map with numpy-seeded parameters and Adam moments."""
    import jax.numpy as jnp

    from gaus_slam_tpu.models import gaussians as G

    def noisy(p, scale):
        return G.Params(*(jnp.asarray(np.asarray(x) + rng.normal(
            0, scale, x.shape).astype(np.float32)) for x in p))

    return gm._replace(params=noisy(gm.params, 1e-3), m=noisy(gm.m, 1e-2),
                       v=G.Params(*(jnp.asarray(rng.random(
                           x.shape).astype(np.float32)) for x in gm.v)),
                       step=jnp.asarray(17, jnp.int32))


def _jax_state(ds, cfg):
    """(JAX Frontend, JAX Backend) with a hand-built run state."""
    import jax.numpy as jnp

    from gaus_slam_tpu.models.frame import ExposureState, Frame, PoseState
    from gaus_slam_tpu.slam.backend import Backend
    from gaus_slam_tpu.slam.frontend import Frontend

    rng = np.random.default_rng(0)
    _, _, gm = _scene()
    jf = Frontend(cfg, queue.Queue(), backend="interpret")
    jf.map = _seeded_map(gm, rng)
    jf.n_active_host = int(gm.n_active)
    jf.cur_lmid, jf.tracking_flag = 2, False
    jf.vel = rng.normal(size=(4, 4)).astype(np.float32)
    jf.avg_depth_l1 = 0.0123
    jf.depth_l1_rec, jf.numpts_rec = [0.01, 0.02], [100, 200]
    c2w8 = ds[8][3]
    jf.local_frames = []
    for t in (8, 9):
        color, depth, _, c2w = ds[t]
        f = Frame(time_idx=t, gt_color=jnp.asarray(color / 255.0, jnp.float32),
                  gt_depth=jnp.asarray(depth), gt_w2c=np.linalg.inv(c2w),
                  kfid=2, frame_type=0 if t == 8 else 2)
        f.est_w2c = (np.linalg.inv(c2w) @ c2w8).astype(np.float32)
        f.mapping_times = 9 - t
        jf.local_frames.append(f)
    jf.local_frames[-1].start_optimizer(jf.local_frames[-1].est_w2c)

    jb = Backend(cfg, backend="interpret")
    jb.map = _seeded_map(gm, rng)
    jb.n_active_host = int(gm.n_active)
    for lmid, first in ((0, 0), (1, 4)):
        lm = _submap(ds, lmid, first)
        lm.map_params = None
        lm.mapping_times = 3 + lmid

        def r(*shape):
            return jnp.asarray(rng.normal(size=shape).astype(np.float32))

        lm.transform = PoseState(r(4), r(3), r(4), r(4), r(3), r(3),
                                 jnp.asarray(5 + lmid, jnp.int32))
        if lmid == 1:
            lm.exposure = ExposureState(r(), r(), r(2), r(2),
                                        jnp.asarray(2, jnp.int32))
        jb.local_maps.add_localmap(lm)
    jb.cur_lmid = 1
    jb.totalpts_rec, jb.ape_rec = [1000, 2000], [0.01, 0.02]
    jb._peak_hist = [1000, 2100]
    return jf, jb


def _port(cfg, jf=None, jb=None):
    from gaus_slam_tpu_torch.slam.backend import Backend
    from gaus_slam_tpu_torch.slam.frontend import Frontend

    tf = Frontend(cfg, queue.Queue(), backend="interpret", device="cpu")
    tb = Backend(cfg, backend="interpret", device="cpu")
    if jf is not None:
        vars(tf).update(convert.frontend_state_from_jax(jf, "cpu"))
        tf.depth_l1_rec, tf.numpts_rec = (list(jf.depth_l1_rec),
                                          list(jf.numpts_rec))
        vars(tb).update(convert.backend_state_from_jax(jb, "cpu"))
    return tf, tb


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(dataset, config, port frontend, port backend, JAX checkpoint dir,
    port checkpoint dir), both checkpoints of the same state."""
    from gaus_slam_tpu.utils.checkpoint import save_run_state as j_save
    from gaus_slam_tpu_torch.utils.checkpoint import save_run_state

    ds = _dataset()
    cfg = _config(ds)
    jf, jb = _jax_state(ds, cfg)
    tf, tb = _port(cfg, jf, jb)
    root = tmp_path_factory.mktemp("ckpt")
    j_save(str(root / "j"), jf, jb, next_frame_idx=10)
    save_run_state(str(root / "t"), tf, tb, next_frame_idx=10)
    return ds, cfg, tf, tb, root / "j", root / "t"


def _eq(a, b, what):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(a, b), what
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), what)


def _assert_map_equal(a, b, what):
    for group in ("params", "m", "v"):
        for f, x, y in zip(PARAM_FIELDS, getattr(a, group), getattr(b, group)):
            _eq(x, y, f"{what} {group}.{f}")
    assert a.step == b.step, what
    _eq(a.active, b.active, f"{what} active")
    _eq(a.n_active, b.n_active, f"{what} n_active")


def _assert_state_equal(tf, tb, rf, rb, ds):
    """Restored (rf, rb) against the state (tf, tb) it was saved from."""
    _assert_map_equal(tf.map, rf.map, "frontend map")
    assert rf.n_active_host == int(tf.map.n_active)
    for k in ("cur_lmid", "avg_depth_l1", "depth_l1_rec", "numpts_rec",
              "tracking_flag"):
        assert getattr(rf, k) == getattr(tf, k), k
    _eq(rf.vel, tf.vel, "vel")
    assert len(rf.local_frames) == len(tf.local_frames)
    for a, b in zip(tf.local_frames, rf.local_frames):
        assert (a.time_idx, a.kfid, a.frame_type, a.mapping_times) == (
            b.time_idx, b.kfid, b.frame_type, b.mapping_times)
        _eq(b.est_w2c, a.get_w2c.detach().numpy(), "live frame w2c")
        color, depth, _, _ = ds[b.time_idx]
        _eq(b.gt_color, torch.as_tensor(np.asarray(color, np.float32)
                                        / np.float32(255)), "live color")
        _eq(b.gt_depth, torch.as_tensor(np.asarray(depth, np.float32)[..., 0]
                                        if np.ndim(depth) == 3 else depth),
            "live depth")
    assert rf.local_frames[-1].pose is not None

    _assert_map_equal(tb.map, rb.map, "backend map")
    assert rb.n_active_host == int(tb.map.n_active)
    for k in ("totalpts_rec", "ape_rec", "_peak_hist"):
        assert getattr(rb, k) == getattr(tb, k), k
    assert rb.cur_lmid == len(tb.local_maps) - 1
    assert len(rb.local_maps) == len(tb.local_maps)
    for a, b in zip(tb.local_maps, rb.local_maps):
        assert (a.lmid, a.tracking_ok, a.mapping_times, list(a.saved_idxs)) \
            == (b.lmid, b.tracking_ok, b.mapping_times, list(b.saved_idxs))
        _eq(b.ref2f0, a.ref2f0, "ref2f0")
        _eq(b.map_desc, np.asarray(a.map_desc, np.float32), "map_desc")
        for fld in a.transform._fields:
            _eq(getattr(b.transform, fld), getattr(a.transform, fld),
                f"transform {fld}")
        assert (a.exposure is None) == (b.exposure is None)
        if a.exposure is not None:
            for fld in a.exposure._fields:
                _eq(getattr(b.exposure, fld), getattr(a.exposure, fld),
                    f"exposure {fld}")
        for i, (fa, fb) in enumerate(zip(a.frames, b.frames)):
            assert (fa.time_idx, fa.kfid, fa.frame_type) == (
                fb.time_idx, fb.kfid, fb.frame_type)
            _eq(fb.est_w2c, fa.est_w2c, "est_w2c")
            _eq(fb.gt_w2c, np.asarray(fa.gt_w2c, np.float32), "gt_w2c")
            assert tuple(fb.est_exposure) == tuple(fa.est_exposure)
            assert (fb.gt_color is not None) == (i in a.saved_idxs)
            if i in a.saved_idxs:
                color = ds[fb.time_idx][0]
                _eq(fb.gt_color, torch.as_tensor(
                    np.asarray(color, np.float32) / np.float32(255)),
                    "kept keyframe color")
    np.testing.assert_array_equal(rb.local_maps.map_descs,
                                  tb.local_maps.map_descs)


def test_port_round_trip_bit_exact(case):
    from gaus_slam_tpu_torch.utils.checkpoint import restore_run_state

    ds, cfg, tf, tb, _, tdir = case
    rf, rb = _port(cfg)
    assert restore_run_state(str(tdir), rf, rb, ds) == 10
    _assert_state_equal(tf, tb, rf, rb, ds)
    # the restored submaps are mapped again, like an uninterrupted run's
    mt0 = rb.local_maps[0].mapping_times
    rb.mapping(0)
    assert rb.local_maps[0].mapping_times == mt0 + 1


def _meta_close(a, b, path=""):
    """Exact, but for the live frames' w2c, which each package recomputes
    from the pose optimizer's quaternion (1 ulp apart)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _meta_close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list) and path.endswith("/w2c"):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=path)
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _meta_close(x, y, f"{path}/{i}")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def test_meta_json_and_arrays_match_jax(case):
    import orbax.checkpoint as ocp

    from gaus_slam_tpu_torch.utils.checkpoint import _flatten, read_run_state

    _, _, _, _, jdir, tdir = case
    with open(jdir / "meta.json") as f:
        jmeta = json.load(f)
    arrays, tmeta = read_run_state(str(tdir))
    _meta_close(jmeta, tmeta)
    jarrays = _flatten(ocp.StandardCheckpointer().restore(
        os.path.abspath(jdir / "arrays")))
    assert sorted(jarrays) == sorted(arrays)
    for k, v in jarrays.items():
        np.testing.assert_array_equal(arrays[k], np.asarray(v), k)
        assert arrays[k].shape == np.shape(v), k


def test_run_state_from_jax_equals_port_restore(case):
    import orbax.checkpoint as ocp

    from gaus_slam_tpu_torch.utils.checkpoint import (apply_run_state,
                                                      restore_run_state)

    ds, cfg, tf, tb, jdir, tdir = case
    tree = ocp.StandardCheckpointer().restore(os.path.abspath(jdir / "arrays"))
    with open(jdir / "meta.json") as f:
        meta = json.load(f)
    af, ab = _port(cfg)
    arrays, meta = convert.run_state_from_jax(tree, meta)
    assert apply_run_state(arrays, meta, af, ab, ds) == 10
    rf, rb = _port(cfg)
    restore_run_state(str(tdir), rf, rb, ds)
    _assert_state_equal(rf, rb, af, ab, ds)


@pytest.mark.slow
def test_driver_resumes_from_checkpoint(tmp_path, monkeypatch):
    """tests/test_full_slam.py:72-123's checks on the port driver."""
    from gaus_slam_tpu_torch.data import get_dataset
    from gaus_slam_tpu_torch.scripts.gaus import rgbd_slam
    from gaus_slam_tpu_torch.utils.checkpoint import restore_run_state
    from gaus_slam_tpu_torch.utils.config import load_config, probe_cameras

    for k, v in dict(SYN_H="48", SYN_W="64", SYN_FRAMES="12",
                     MESH_DEVICES="off").items():
        monkeypatch.setenv(k, v)
    path = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "synthetic", "config.py")
    cfg = load_config(path)
    cfg["vis_base_dir"] = str(tmp_path)
    cfg["backend"]["save_ckpt"] = True
    result = rgbd_slam(cfg, backend="interpret", device="cpu")
    assert np.isfinite(result["ATE RMSE"])
    ckpt = tmp_path / "ckpt"
    assert (ckpt / "meta.json").exists() and (ckpt / "arrays.npz").exists()

    cfg2 = load_config(path)
    cfg2["vis_base_dir"] = str(tmp_path / "resumed")
    result2 = rgbd_slam(cfg2, backend="interpret", device="cpu",
                        resume_from=str(ckpt))
    assert np.isfinite(result2["ATE RMSE"]) and result2["ATE RMSE"] < 0.1
    assert np.isfinite(result2["PSNR"])

    from gaus_slam_tpu_torch.slam.backend import Backend
    from gaus_slam_tpu_torch.slam.frontend import Frontend

    cfg3 = load_config(path)
    dataset = get_dataset(cfg3["data"])
    color0, _, intrinsics, _ = dataset[0]
    probe_cameras(cfg3, color0, intrinsics)
    fe = Frontend(cfg3, queue.Queue(), backend="interpret", device="cpu")
    be = Backend(cfg3, backend="interpret", device="cpu")
    restore_run_state(str(ckpt), fe, be, dataset)
    assert len(be.local_maps) >= 1
    lm0 = be.local_maps[0]
    assert lm0.saved_idxs, "restored submap lost its retained keyframes"
    for i in lm0.saved_idxs:
        assert lm0.frames[i].gt_color is not None
    mt0 = lm0.mapping_times
    be.mapping(0)
    assert lm0.mapping_times == mt0 + 1
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta.get("peak_hist"), "checkpoint lost the merge-peak history"
    assert be._peak_hist == [int(x) for x in meta["peak_hist"]]
