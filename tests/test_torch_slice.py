"""The port's slice as a whole against the JAX package, from the same map.

The schedule of chip_smoke.py phase 3, cut short: map init from frame 0
(the JAX map, carried into the port with convert.py) + a 4-iteration
mapping_loop (rebin 2, coarse mapping stride 3), then 2 tracked frames:
tracking binning with a stride-3 phase-major cache, an 8-iteration
tracking_loop (5 coarse, compact) with the fused keyframe view and the
constant-velocity prediction, the keyframe test, and on keyframes densify
+ prune + mapping_loop + prune. JAX runs its Pallas kernels in interpret
mode; the port runs the plain versions on the CPU.

Tolerances: float32 drift through Adam — the two packages sum in
different orders, and Adam's normalized step turns rounding-level
gradient differences into parameter differences of up to ~lr per step
(a parameter whose true gradient is zero, such as the spin of an
isotropic surfel about its normal, takes steps of +-lr on rounding
noise alone). So: losses to 1e-3 relative; pose translation to 2e-4 m
(a tenth of a tracking step, lr 2e-3) and rotation entries to 4e-4 (one
step of the rotation lr); map parameters each within the drift two
Adam runs can reach (2 * lr * steps) and 90% of them within 2e-3
relative; integer state (n_active, n_low, keyframe decisions, iteration
counts) exactly.
"""
import random
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaus_slam_tpu.data.synthetic import SyntheticDataset
from gaus_slam_tpu.models.frame import LrSchedule as JLr
from gaus_slam_tpu.models.frame import init_pose as j_init_pose
from gaus_slam_tpu.ops import binning as JB
from gaus_slam_tpu.ops.camera import camera_from_intrinsics as j_cam
from gaus_slam_tpu.ops.composite_ref import frame_to_tiles as j_tiles
from gaus_slam_tpu.render import RenderOptions as JOpts
from gaus_slam_tpu.render import bin_for_tracking as j_bin_track
from gaus_slam_tpu.slam import densify as JD
from gaus_slam_tpu.slam.init_map import initialize_map as j_init_map
from gaus_slam_tpu.slam.loss import LossConfig as JLoss
from gaus_slam_tpu.slam.steps import MapConfig as JMap
from gaus_slam_tpu.slam.steps import TrackConfig as JTrack
from gaus_slam_tpu.slam.steps import mapping_loop as j_map_loop
from gaus_slam_tpu.slam.steps import tracking_loop as j_track_loop
from gaus_slam_tpu_torch import convert
from gaus_slam_tpu_torch.models.frame import LrSchedule as TLr
from gaus_slam_tpu_torch.ops import binning as TB
from gaus_slam_tpu_torch.ops.camera import camera_from_intrinsics as t_cam
from gaus_slam_tpu_torch.ops.composite_ref import frame_to_tiles as t_tiles
from gaus_slam_tpu_torch.render import RenderOptions as TOpts
from gaus_slam_tpu_torch.render import bin_for_tracking as t_bin_track
from gaus_slam_tpu_torch.slam import densify as TD
from gaus_slam_tpu_torch.slam.loss import LossConfig as TLoss
from gaus_slam_tpu_torch.slam.steps import MapConfig as TMap
from gaus_slam_tpu_torch.slam.steps import TrackConfig as TTrack
from gaus_slam_tpu_torch.slam.steps import mapping_loop as t_map_loop
from gaus_slam_tpu_torch.slam.steps import tracking_loop as t_track_loop


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


H, W, CAP = 48, 64, 4096
REBIN, MAP_STRIDE, STRIDE = 2, 3, 3
LRS = (("opacity_lr", 0.05), ("rgb_lr", 0.0025), ("rotation_lr", 0.001),
       ("scaling_lr", 0.001), ("xyz_lr", 0.0001))


class Cfg(NamedTuple):
    h: int = H
    w: int = W
    cap: int = CAP
    frames: int = 2
    map_iters: int = 4
    track_iters: int = 8
    coarse_iters: int = 5


# chip_smoke.py's schedule in full (20 mapping, 30 tracking iterations of
# which 18 coarse, 4 frames) at the synthetic profile's default 120x160
FULL = Cfg(h=120, w=160, cap=131072, frames=4, map_iters=20,
           track_iters=30, coarse_iters=18)


def _schedules(lr_cls):
    return (lr_cls(0.0004, 0.0004 / 5, 30), lr_cls(0.002, 0.002 / 5, 30))


def run_jax(ds, c=Cfg()):
    cam = j_cam(c.h, c.w, ds.intrinsics, np.eye(4))
    opts = JOpts(grid=JB.make_grid(cam, 16, 16), backend="interpret",
                 pair_budget_factor=1.35, max_tiles_per_gaussian=4)
    lcfg, dcfg, mcfg = JLoss(), JD.DensifyConfig(), JMap(lrs=LRS)
    rot, tr = _schedules(JLr)
    tcfg = JTrack(num_iters=c.track_iters, converged_th=5e-4, rot_sched=rot,
                  trans_sched=tr, coarse_iters=c.coarse_iters,
                  coarse_stride=STRIDE)
    pick = random.Random(0)
    frames, log = [], {"map_loss": [], "track": []}

    def mapping(gm):
        sel = [pick.choice(frames) for _ in range(c.map_iters // REBIN)]
        gm, aux = j_map_loop(gm, jnp.stack([f[3].w2c for f in sel]),
                             jnp.stack([f[2] for f in sel]), cam, opts, mcfg,
                             lcfg, rebin_every=REBIN,
                             coarse_stride=MAP_STRIDE)
        log["map_loss"].append(float(aux["loss"]))
        return gm

    color, depth = ds[0][0] / 255.0, ds[0][1]
    pose0 = j_init_pose(np.eye(4))
    frames.append((color, depth, j_tiles(jnp.asarray(color),
                                         jnp.asarray(depth), opts.grid), pose0))
    gm0 = j_init_map(c.cap, jnp.asarray(color), jnp.asarray(depth),
                     jnp.eye(4), cam)
    gm = mapping(gm0)
    pred = pose0
    for f in range(1, c.frames + 1):
        color, depth = ds[f][0] / 255.0, ds[f][1]
        gt = j_tiles(jnp.asarray(color), jnp.asarray(depth), opts.grid)
        cache = j_bin_track(gm, cam.replace_w2c(pred.w2c), opts,
                            coarse_strides=(STRIDE,))
        pose, aux = j_track_loop(cache, pred, gt, cam, opts, tcfg, lcfg,
                                 want_view=True, prev_pose=frames[-1][3],
                                 predict=True, compact_coarse=True)
        frames.append((color, depth, gt, pose))
        pred = aux["pred_pose"]
        n_low = int(aux["n_low"]) - (opts.grid.num_tiles * 256 - c.h * c.w)
        kf = n_low > c.h * c.w * 0.05
        if kf:
            gm = JD.add_new_gaussians(gm, pose.w2c, jnp.asarray(color),
                                      jnp.asarray(depth), aux["view"], cam,
                                      opts, dcfg, lcfg)
            gm = JD.prune_gaussians(gm, dcfg)
            gm = mapping(gm)
            gm = JD.prune_gaussians(gm, dcfg)
        log["track"].append(dict(
            iters=int(aux["iters"]), loss=float(aux["loss"]), kf=kf,
            n_low=n_low, w2c=np.asarray(pose.w2c),
            n_active=int(gm.n_active)))
    return gm0, gm, log


def run_port(ds, gm0, c=Cfg()):
    dev = "cpu"
    cam = t_cam(c.h, c.w, ds.intrinsics, np.eye(4), device=dev)
    opts = TOpts(grid=TB.make_grid(cam, 16, 16), pair_budget_factor=1.35,
                 max_tiles_per_gaussian=4)
    lcfg, dcfg, mcfg = TLoss(), TD.DensifyConfig(), TMap(lrs=LRS)
    rot, tr = _schedules(TLr)
    tcfg = TTrack(num_iters=c.track_iters, converged_th=5e-4, rot_sched=rot,
                  trans_sched=tr, coarse_iters=c.coarse_iters,
                  coarse_stride=STRIDE)
    pick = random.Random(0)
    frames, log = [], {"map_loss": [], "track": []}

    def mapping(gm):
        sel = [pick.choice(frames) for _ in range(c.map_iters // REBIN)]
        gm, aux = t_map_loop(gm, torch.stack([f[3].w2c for f in sel]),
                             torch.stack([f[2] for f in sel]), cam, opts,
                             mcfg, lcfg, rebin_every=REBIN,
                             coarse_stride=MAP_STRIDE)
        log["map_loss"].append(float(aux["loss"]))
        return gm

    def tens(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    color, depth = tens(ds[0][0] / 255.0), tens(ds[0][1])
    pose0 = convert.pose_from_numpy(
        {k: np.asarray(v) for k, v in j_init_pose(np.eye(4))._asdict().items()},
        device=dev)
    frames.append((color, depth, t_tiles(color, depth, opts.grid), pose0))
    gm = convert.gaussian_map_from_numpy(
        {"params": {k: np.asarray(v) for k, v in gm0.params._asdict().items()},
         "m": {k: np.asarray(v) for k, v in gm0.m._asdict().items()},
         "v": {k: np.asarray(v) for k, v in gm0.v._asdict().items()},
         "step": np.asarray(gm0.step), "active": np.asarray(gm0.active),
         "n_active": np.asarray(gm0.n_active)}, device=dev)
    gm = mapping(gm)
    pred = pose0
    for f in range(1, c.frames + 1):
        color, depth = tens(ds[f][0] / 255.0), tens(ds[f][1])
        gt = t_tiles(color, depth, opts.grid)
        cache = t_bin_track(gm, cam.replace_w2c(pred.w2c), opts,
                            coarse_strides=(STRIDE,))
        pose, aux = t_track_loop(cache, pred, gt, cam, opts, tcfg, lcfg,
                                 want_view=True, prev_pose=frames[-1][3],
                                 predict=True, compact_coarse=True)
        frames.append((color, depth, gt, pose))
        pred = aux["pred_pose"]
        n_low = int(aux["n_low"]) - (opts.grid.num_tiles * 256 - c.h * c.w)
        kf = n_low > c.h * c.w * 0.05
        if kf:
            gm = TD.add_new_gaussians(gm, pose.w2c, color, depth, aux["view"],
                                      cam, opts, dcfg, lcfg)
            gm = TD.prune_gaussians(gm, dcfg)
            gm = mapping(gm)
            gm = TD.prune_gaussians(gm, dcfg)
        log["track"].append(dict(
            iters=int(aux["iters"]), loss=float(aux["loss"]), kf=kf,
            n_low=n_low, w2c=pose.w2c.numpy(), n_active=int(gm.n_active)))
    return gm, log


@pytest.fixture(scope="module")
def both():
    ds = SyntheticDataset(height=H, width=W, num_frames=60)
    gm0, jgm, jlog = run_jax(ds)
    tgm, tlog = run_port(ds, gm0)
    return jgm, jlog, tgm, tlog


def check_logs(jlog, tlog, n_low_px=0, loss_rtol=1e-3, t_atol=2e-4,
               r_atol=4e-4):
    assert len(jlog["map_loss"]) == len(tlog["map_loss"]) >= 1
    np.testing.assert_allclose(tlog["map_loss"], jlog["map_loss"],
                               rtol=loss_rtol)
    for j, t in zip(jlog["track"], tlog["track"]):
        assert (t["iters"], t["kf"], t["n_active"]) == \
            (j["iters"], j["kf"], j["n_active"]), (t, j)
        assert abs(t["n_low"] - j["n_low"]) <= n_low_px
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=loss_rtol)
        np.testing.assert_allclose(t["w2c"][:3, 3], j["w2c"][:3, 3], rtol=0,
                                   atol=t_atol)
        np.testing.assert_allclose(t["w2c"][:3, :3], j["w2c"][:3, :3],
                                   rtol=0, atol=r_atol)


def test_slice_losses_and_poses_match_jax(both):
    _, jlog, _, tlog = both
    check_logs(jlog, tlog)


@pytest.mark.slow
def test_slice_full_schedule_matches_jax():
    """chip_smoke.py's full schedule at 120x160 (~2 min on the CPU). Over
    20 Adam steps per mapping_loop and 30 per tracked frame the drift
    compounds: losses agree to 1e-2 relative, poses to 5e-4 m and 1e-3
    in rotation, and a pixel may cross the keyframe view's alpha test by
    rounding (n_low within 2).
    Prints each frame's translation error against ground truth for both
    packages, beside its constant-velocity init's (run with -s)."""
    ds = SyntheticDataset(height=FULL.h, width=FULL.w, num_frames=60)
    gm0, _, jlog = run_jax(ds, FULL)
    _, tlog = run_port(ds, gm0, FULL)
    c2w0 = ds[0][3]

    def err(w2c, f):
        est = np.linalg.inv(np.asarray(w2c, np.float64))
        gt = np.linalg.inv(c2w0) @ ds[f][3]
        return float(np.linalg.norm(est[:3, 3] - gt[:3, 3]))

    for name, log in (("jax", jlog), ("port", tlog)):
        w2cs = [np.eye(4)] + [r["w2c"] for r in log["track"]]
        for f in range(1, FULL.frames + 1):
            pred = (w2cs[f - 1] @ np.linalg.inv(w2cs[f - 2]) @ w2cs[f - 1]
                    if f >= 2 else w2cs[0])
            print(f"{name} frame {f}: t_err {err(w2cs[f], f):.5f} m, "
                  f"constant-velocity init {err(pred, f):.5f} m, "
                  f"keyframe {log['track'][f - 1]['kf']}, "
                  f"loss {log['track'][f - 1]['loss']:.4f}")
    check_logs(jlog, tlog, n_low_px=2, loss_rtol=1e-2, t_atol=5e-4,
               r_atol=1e-3)


def test_slice_map_matches_jax(both):
    jgm, _, tgm, _ = both
    n = int(jgm.n_active)
    steps = int(jgm.step)
    assert int(tgm.n_active) == n and tgm.step == steps > 0
    np.testing.assert_array_equal(tgm.active.numpy(), np.asarray(jgm.active))
    lrs = dict(LRS)
    for f, key in (("xyz", "xyz_lr"), ("log_scales", "scaling_lr"),
                   ("quats", "rotation_lr"), ("opacity_logit", "opacity_lr"),
                   ("rgb", "rgb_lr")):
        a = np.asarray(getattr(jgm.params, f))[:n]
        b = getattr(tgm.params, f).numpy()[:n]
        assert np.abs(a - b).max() <= 2 * lrs[key] * steps, f
        rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-2)
        assert np.mean(rel > 2e-3) < 0.1, (f, np.mean(rel > 2e-3))


def test_densify_matches_jax():
    """Keyframe densify + prune on the same map and the same detached
    view (a frame far enough from the map to need new surfels)."""
    from gaus_slam_tpu.render import render_view as j_render_view

    ds = SyntheticDataset(height=H, width=W, num_frames=8)
    cam = j_cam(H, W, ds.intrinsics, np.eye(4))
    opts = JOpts(grid=JB.make_grid(cam, 16, 16), backend="interpret",
                 pair_budget_factor=1.35, max_tiles_per_gaussian=4)
    color0, depth0, _, c2w0 = ds[0]
    color, depth, _, c2w = ds[3]
    w2c = (np.linalg.inv(c2w) @ c2w0).astype(np.float32)
    gm0 = j_init_map(CAP, jnp.asarray(color0 / 255.0), jnp.asarray(depth0),
                     jnp.eye(4), cam)
    view = j_render_view(gm0, cam.replace_w2c(jnp.asarray(w2c)), opts)
    n_low = int(jnp.sum(view[:, 4] < 0.5)) - (opts.grid.num_tiles * 256
                                              - H * W)
    assert n_low > H * W * 0.05          # a keyframe by the slice's test
    jgm = JD.add_new_gaussians(gm0, jnp.asarray(w2c),
                               jnp.asarray(color / 255.0), jnp.asarray(depth),
                               view, cam, opts, JD.DensifyConfig(), JLoss())
    jgm = JD.prune_gaussians(jgm, JD.DensifyConfig())

    tcam = t_cam(H, W, ds.intrinsics, np.eye(4), device="cpu")
    topts = TOpts(grid=TB.make_grid(tcam, 16, 16), pair_budget_factor=1.35,
                  max_tiles_per_gaussian=4)
    tgm = convert.gaussian_map_from_numpy(
        {"params": gm0.params._asdict(), "m": gm0.m._asdict(),
         "v": gm0.v._asdict(), "step": gm0.step, "active": gm0.active,
         "n_active": gm0.n_active}, device="cpu")
    tgm = TD.add_new_gaussians(
        tgm, torch.tensor(w2c),
        torch.as_tensor((color / 255.0).astype(np.float32)),
        torch.as_tensor(depth), torch.as_tensor(np.array(view)), tcam, topts,
        TD.DensifyConfig(), TLoss())
    tgm = TD.prune_gaussians(tgm, TD.DensifyConfig())
    n = int(jgm.n_active)
    assert n > int(gm0.n_active) and int(tgm.n_active) == n
    np.testing.assert_array_equal(tgm.active.numpy(), np.asarray(jgm.active))
    for f in ("xyz", "log_scales", "opacity_logit", "rgb"):
        np.testing.assert_allclose(getattr(tgm.params, f).numpy()[:n],
                                   np.asarray(getattr(jgm.params, f))[:n],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    # Orientation: on the box's axis-aligned walls the unprojected normal
    # is exactly axis-aligned or off by rounding, depending on the point
    # transform's summation order, and surfel_quat_from_normal's
    # degenerate-normal test (|up x n| < 1e-9) then picks the identity
    # fallback or the wall's true orientation. So a row matches (to 1e-3:
    # normals at wall edges are ill-conditioned), or one side holds that
    # fallback.
    jq = np.asarray(jgm.params.quats)[:n]
    tq = tgm.params.quats.numpy()[:n]
    ident = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    same = np.abs(jq - tq).max(1) <= 1e-3
    fallback = (np.abs(jq - ident).max(1) == 0) | (np.abs(tq - ident).max(1) == 0)
    assert np.all(same | fallback)
    assert same.mean() > 0.5
