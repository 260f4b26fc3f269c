"""The loops the frontend's other paths run, against the JAX package:
tracking_loop under the reference render backend (no coarse phase, the
plain forward and K5's plain version) at a tiny map (32x32, capacity
1024: JAX's reference forward traces num_tiles x R/128 chunks), and one
mapping_step with exposure optimization (the frontend's per-step mapping
path).

Tolerances: one run from the same state, so float32 summation order
only: poses to 5e-5 (a fortieth of a tracking step, lr 2e-3), the loss
to 1e-4 relative, the exposure to 1e-6, map parameters within 2 * lr of
each other and 90% of them within 2e-3 relative (one Adam step turns a
rounding-level gradient difference into up to lr).
"""
import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch import convert
from test_torch_frontend import _assert_map_close


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny_scene(h=32, w=32, cap=1024):
    from gaus_slam_tpu.data.synthetic import SyntheticDataset
    from gaus_slam_tpu.ops.camera import camera_from_intrinsics as j_cam
    from gaus_slam_tpu.slam.init_map import initialize_map as j_init_map
    import jax.numpy as jnp

    ds = SyntheticDataset(height=h, width=w, num_frames=8)
    cam = j_cam(h, w, ds.intrinsics, np.eye(4))
    color, depth = ds[0][0] / 255.0, ds[0][1]
    gm = j_init_map(cap, jnp.asarray(color), jnp.asarray(depth), jnp.eye(4),
                    cam)
    return ds, cam, gm


def test_reference_tracking_loop_matches_jax():
    """tracking_loop under backend="reference": no coarse phase (all its
    iterations render every tile), the plain forward and K5's plain
    version, from the same cache, pose and frame."""
    import jax.numpy as jnp

    from gaus_slam_tpu.models.frame import LrSchedule as JLr
    from gaus_slam_tpu.models.frame import init_pose as j_init_pose
    from gaus_slam_tpu.ops import binning as JB
    from gaus_slam_tpu.ops.composite_ref import frame_to_tiles as j_tiles
    from gaus_slam_tpu.render import RenderOptions as JOpts
    from gaus_slam_tpu.render import bin_for_tracking as j_bin
    from gaus_slam_tpu.slam.loss import LossConfig as JLoss
    from gaus_slam_tpu.slam.steps import TrackConfig as JTrack
    from gaus_slam_tpu.slam.steps import tracking_loop as j_track
    from gaus_slam_tpu_torch.models.frame import LrSchedule as TLr
    from gaus_slam_tpu_torch.ops import binning as TB
    from gaus_slam_tpu_torch.ops.camera import camera_from_intrinsics as t_cam
    from gaus_slam_tpu_torch.ops.composite_ref import frame_to_tiles as t_tiles
    from gaus_slam_tpu_torch.render import RenderOptions as TOpts
    from gaus_slam_tpu_torch.render import bin_for_tracking as t_bin
    from gaus_slam_tpu_torch.slam.loss import LossConfig as TLoss
    from gaus_slam_tpu_torch.slam.steps import TrackConfig as TTrack
    from gaus_slam_tpu_torch.slam.steps import tracking_loop as t_track

    ds, jcam, jgm = _tiny_scene()
    h, w = jcam.height, jcam.width
    c2w0, (color, depth, _, c2w) = ds[0][3], ds[2]
    init = (np.linalg.inv(c2w0) @ ds[1][3])       # previous frame's pose
    init = np.linalg.inv(init).astype(np.float32)
    kw = dict(pair_budget_factor=1.35, max_tiles_per_gaussian=4,
              backend="reference")
    jo = JOpts(grid=JB.make_grid(jcam, 16, 16), **kw)
    jpose = j_init_pose(init)
    jcache = j_bin(jgm, jcam.replace_w2c(jpose.w2c), jo)
    assert jcache.raw_t.shape[1] <= 2048
    mk = dict(num_iters=5, converged_th=-1.0, coarse_iters=3, coarse_stride=2)
    jt = JTrack(rot_sched=JLr(4e-4, 8e-5, 5), trans_sched=JLr(2e-3, 4e-4, 5),
                **mk)
    jgt = j_tiles(jnp.asarray(color / 255.0), jnp.asarray(depth), jo.grid)
    jp, jaux = j_track(jcache, jpose, jgt, jcam, jo, jt, JLoss(),
                       want_view=True)

    tcam = t_cam(h, w, ds.intrinsics, np.eye(4), device="cpu")
    to = TOpts(grid=TB.make_grid(tcam, 16, 16), **kw)
    tgm = convert.gaussian_map_from_numpy(jgm, device="cpu")
    tpose = convert.pose_from_numpy(jpose, device="cpu")
    tcache = t_bin(tgm, tcam.replace_w2c(tpose.w2c), to)
    np.testing.assert_array_equal(tcache.tile_start.numpy(),
                                  np.asarray(jcache.tile_start))
    tt = TTrack(rot_sched=TLr(4e-4, 8e-5, 5), trans_sched=TLr(2e-3, 4e-4, 5),
                **mk)
    tgt = t_tiles(torch.tensor((color / 255.0).astype(np.float32)),
                  torch.tensor(depth), to.grid)
    tp, taux = t_track(tcache, tpose, tgt, tcam, to, tt, TLoss(),
                       want_view=True)
    assert taux["iters"] == int(jaux["iters"]) == 5
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(tp.w2c.numpy(), np.asarray(jp.w2c), rtol=0,
                               atol=5e-5)
    assert abs(int(taux["n_low"]) - int(jaux["n_low"])) <= 1
    # the pose moved: the loop did real work
    assert np.abs(tp.w2c.numpy() - init).max() > 1e-4


def test_mapping_step_with_exposure_matches_jax():
    """The per-step mapping path with exposure optimization on: the map
    and the (gain, bias) after one step from the same state."""
    import jax.numpy as jnp

    from gaus_slam_tpu.models.frame import LrSchedule as JLr
    from gaus_slam_tpu.models.frame import init_exposure as j_exp
    from gaus_slam_tpu.ops import binning as JB
    from gaus_slam_tpu.ops.composite_ref import frame_to_tiles as j_tiles
    from gaus_slam_tpu.render import RenderOptions as JOpts
    from gaus_slam_tpu.slam.loss import LossConfig as JLoss
    from gaus_slam_tpu.slam.steps import MapConfig as JMap
    from gaus_slam_tpu.slam.steps import mapping_step as j_step
    from gaus_slam_tpu_torch.models.frame import LrSchedule as TLr
    from gaus_slam_tpu_torch.models.frame import init_exposure as t_exp
    from gaus_slam_tpu_torch.ops import binning as TB
    from gaus_slam_tpu_torch.ops.camera import camera_from_intrinsics as t_cam
    from gaus_slam_tpu_torch.ops.composite_ref import frame_to_tiles as t_tiles
    from gaus_slam_tpu_torch.render import RenderOptions as TOpts
    from gaus_slam_tpu_torch.slam.loss import LossConfig as TLoss
    from gaus_slam_tpu_torch.slam.steps import MapConfig as TMap
    from gaus_slam_tpu_torch.slam.steps import mapping_step as t_step

    ds, jcam, jgm = _tiny_scene(48, 64, 4096)
    color, depth = ds[1][0] / 255.0, ds[1][1]
    w2c = (np.linalg.inv(ds[1][3]) @ ds[0][3]).astype(np.float32)
    lrs = (("opacity_lr", 0.05), ("rgb_lr", 0.0025), ("rotation_lr", 0.001),
           ("scaling_lr", 0.001), ("xyz_lr", 0.0001))
    kw = dict(pair_budget_factor=1.35, max_tiles_per_gaussian=4)
    jo = JOpts(grid=JB.make_grid(jcam, 16, 16), backend="interpret", **kw)
    jl = JLoss(enable_exposure=True)
    e0 = j_exp()
    e0 = e0._replace(gain=jnp.float32(1.1), bias=jnp.float32(-0.05))
    jgm2, je, _ = j_step(jgm, jnp.asarray(w2c),
                         j_tiles(jnp.asarray(color), jnp.asarray(depth),
                                 jo.grid), e0, jnp.bool_(True),
                         JLr(0.005, 0.0001, 60), jcam, jo, JMap(lrs=lrs), jl)

    tcam = t_cam(jcam.height, jcam.width, ds.intrinsics, np.eye(4),
                 device="cpu")
    to = TOpts(grid=TB.make_grid(tcam, 16, 16), **kw)
    tgm = convert.gaussian_map_from_numpy(jgm, device="cpu")
    te0 = t_exp("cpu")._replace(gain=torch.tensor(1.1),
                               bias=torch.tensor(-0.05))
    tgm2, tex, _ = t_step(tgm, torch.tensor(w2c),
                          t_tiles(torch.tensor(color.astype(np.float32)),
                                  torch.tensor(depth), to.grid), te0, True,
                          TLr(0.005, 0.0001, 60), tcam, to, TMap(lrs=lrs),
                          TLoss(enable_exposure=True))
    assert tex.step == 1
    np.testing.assert_allclose([float(tex.gain), float(tex.bias)],
                               [float(je.gain), float(je.bias)], rtol=0,
                               atol=1e-6)
    assert abs(float(tex.gain) - 1.1) > 1e-3      # the exposure stepped
    _assert_map_close(tgm2, jgm2, steps_bound=1)
