"""The port's backend against the JAX package's, at 48x64.

  * add_params / transform / transform_params on a numpy-seeded map:
    active rows and n_active exact, parameters within 1e-6.
  * render_tracking with ``pre_w2c`` and one backend_tracking_step: pose
    within 5e-5, loss within 1e-4 relative (float32 summation order
    only, as tests/test_torch_steps.py).
  * ba_step and mapping_step with the frame's frozen exposure composed in
    (exposure on): exposure within 1e-6, the map within one Adam step.
  * Localmaps on converted LocalMaps; process_localmap from identical
    state for the first and a later submap: the same task queue, covis
    list, RNG state, capacity and merge-peak history, the merged map
    within 1e-6; the capacity policy on a set of peak histories; one
    drain of a short queue (num_ba_iters 4): submap transforms within
    5e-5.

The submaps are built as the frontend cuts them (each map in its first
frame's camera frame, frame poses relative to it) from the synthetic
sequence's ground truth, without running a frontend. JAX runs its Pallas
kernels in interpret mode; the port runs the plain versions on the CPU.
"""
import os
import random

import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch import convert
from test_torch_frontend import LRS

H, W = 48, 64
ENV = dict(SYN_H=str(H), SYN_W=str(W), SYN_BA_ITERS="4", SYN_MAX_FRAMES="3")
CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs",
                      "synthetic", "config.py")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _dataset():
    from gaus_slam_tpu.data.synthetic import SyntheticDataset

    return SyntheticDataset(height=H, width=W, num_frames=60)


def _config(ds, **tpu):
    from gaus_slam_tpu.utils.config import load_config, probe_cameras

    old = {k: os.environ.get(k) for k in ENV}
    os.environ.update(ENV)
    try:
        cfg = load_config(CONFIG)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    probe_cameras(cfg, ds[0][0], ds.intrinsics)
    # small buckets, so that the merges grow the global map
    cfg["tpu"].update(capacity_quantum=4096, backend_capacity=0,
                      mesh_devices="off", **tpu)
    return cfg


def _submap(ds, lmid, first, n_frames=4, cap=4096):
    """A JAX LocalMap of frames first .. first+n_frames-1: the map of the
    first frame in its own camera frame, each frame's pose relative to
    it (as the frontend leaves them), cut as the frontend cuts."""
    import jax.numpy as jnp

    from gaus_slam_tpu.models import gaussians as G
    from gaus_slam_tpu.models.frame import Frame
    from gaus_slam_tpu.models.submap import LocalMap
    from gaus_slam_tpu.ops.camera import camera_from_intrinsics
    from gaus_slam_tpu.slam.init_map import initialize_map

    cam = camera_from_intrinsics(H, W, ds.intrinsics, np.eye(4))
    c2w0 = np.asarray(ds[first][3], np.float64)
    frames = []
    for t in range(first, first + n_frames):
        color, depth, _, c2w = ds[t]
        f = Frame(time_idx=t, gt_color=jnp.asarray(color / 255.0, jnp.float32),
                  gt_depth=jnp.asarray(depth), gt_w2c=np.linalg.inv(c2w),
                  kfid=lmid, frame_type=0 if t == first else 2)
        f.est_w2c = (np.linalg.inv(c2w) @ c2w0).astype(np.float32)
        frames.append(f)
    gm = initialize_map(cap, frames[0].gt_color, frames[0].gt_depth,
                        jnp.eye(4), cam)
    return LocalMap.cut(lmid, frames, G.extract_params(gm), num_frame_saved=2,
                        rng=random.Random(lmid), n_active_host=int(gm.n_active))


def _ops(ds, jcam):
    """(JAX options, port camera, port options) at the bench factors."""
    from gaus_slam_tpu.ops import binning as JB
    from gaus_slam_tpu.render import RenderOptions as JOpts
    from gaus_slam_tpu_torch.ops import binning as TB
    from gaus_slam_tpu_torch.ops.camera import camera_from_intrinsics as t_cam
    from gaus_slam_tpu_torch.render import RenderOptions as TOpts

    kw = dict(pair_budget_factor=1.35, max_tiles_per_gaussian=4)
    tcam = t_cam(H, W, ds.intrinsics, np.eye(4), device="cpu")
    return (JOpts(grid=JB.make_grid(jcam, 16, 16), backend="interpret", **kw),
            tcam, TOpts(grid=TB.make_grid(tcam, 16, 16), **kw))


def _scene():
    """(dataset, JAX camera, JAX map of frame 0 at the identity)."""
    import jax.numpy as jnp

    from gaus_slam_tpu.ops.camera import camera_from_intrinsics
    from gaus_slam_tpu.slam.init_map import initialize_map

    ds = _dataset()
    cam = camera_from_intrinsics(H, W, ds.intrinsics, np.eye(4))
    gm = initialize_map(4096, jnp.asarray(ds[0][0] / 255.0, jnp.float32),
                        jnp.asarray(ds[0][1]), jnp.eye(4), cam)
    return ds, cam, gm


def _rel_w2c(ds, t, ref=0):
    """w2c of frame t in frame ref's camera frame."""
    return (np.linalg.inv(ds[t][3]) @ np.asarray(ds[ref][3])).astype(np.float32)


def _tiles(ds, t, jgrid, tgrid):
    import jax.numpy as jnp

    from gaus_slam_tpu.ops.composite_ref import frame_to_tiles as j_tiles
    from gaus_slam_tpu_torch.ops.composite_ref import frame_to_tiles as t_tiles

    color, depth = (ds[t][0] / 255.0).astype(np.float32), ds[t][1]
    return (j_tiles(jnp.asarray(color), jnp.asarray(depth), jgrid),
            t_tiles(torch.tensor(color), torch.tensor(depth), tgrid))


# ---------------------------------------------------------------------------


def test_add_params_and_transform_match_jax():
    """The merge's append (compacting the donor's valid rows after the
    map's, zeroed moments, rows past capacity dropped) and the rigid
    transforms, on numpy-seeded maps."""
    import jax.numpy as jnp

    from gaus_slam_tpu.models import gaussians as JG
    from gaus_slam_tpu.ops.se3 import pose_matrix as j_pose
    from gaus_slam_tpu.slam.backend import transform_params as j_tp
    from gaus_slam_tpu_torch.models import gaussians as TG
    from gaus_slam_tpu_torch.slam.backend import transform_params as t_tp

    rng = np.random.default_rng(3)
    cap, n0 = 512, 300

    def params(n):
        return jax_tree({"xyz": rng.normal(size=(n, 3)),
                         "log_scales": rng.normal(size=(n, 2)),
                         "quats": rng.normal(size=(n, 4)),
                         "opacity_logit": rng.normal(size=(n, 1)),
                         "rgb": rng.uniform(size=(n, 3))})

    jgm = JG.GaussianMap(
        params=JG.Params(**params(cap)), m=JG.Params(**params(cap)),
        v=JG.Params(**params(cap)), step=jnp.int32(7),
        active=jnp.arange(cap) < n0, n_active=jnp.int32(n0))
    tgm = convert.gaussian_map_from_numpy(jgm, device="cpu")
    donor = params(400)
    valid = rng.uniform(size=400) < 0.6          # ~240 rows: 28 dropped
    jd, td = JG.Params(**donor), convert._params(donor, "cpu")
    j1 = JG.add_params(jgm, jd, jnp.asarray(valid))
    t1 = TG.add_params(tgm, td, torch.as_tensor(valid))
    assert int(t1.n_active) == int(j1.n_active) == cap
    np.testing.assert_array_equal(t1.active.numpy(), np.asarray(j1.active))
    q = rng.normal(size=4)
    m = np.asarray(j_pose(jnp.asarray(q / np.linalg.norm(q), jnp.float32),
                          jnp.asarray(rng.normal(size=3), jnp.float32)))
    j2 = JG.transform(j1, jnp.asarray(m))
    t2 = TG.transform(t1, torch.as_tensor(m))
    for part in ("params", "m", "v"):
        for f in TG.PARAM_FIELDS:
            np.testing.assert_allclose(
                getattr(getattr(t2, part), f).numpy(),
                np.asarray(getattr(getattr(j2, part), f)), rtol=0, atol=1e-6,
                err_msg=f"{part}.{f}")
    np.testing.assert_allclose(
        np.concatenate([p.numpy() for p in t_tp(td, torch.as_tensor(m))], 1),
        np.concatenate([np.asarray(p) for p in j_tp(jd, jnp.asarray(m))], 1),
        rtol=0, atol=1e-6)


def jax_tree(d):
    import jax.numpy as jnp

    return {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in d.items()}


def test_render_tracking_pre_w2c_matches_jax():
    """The effective camera pre_w2c @ pose and the rotated, detached
    quaternions: the render and the pose gradient."""
    import jax
    import jax.numpy as jnp

    from gaus_slam_tpu.models.frame import init_pose as j_init_pose
    from gaus_slam_tpu.render import bin_for_tracking as j_bin
    from gaus_slam_tpu.render import render_tracking as j_render
    from gaus_slam_tpu_torch.render import bin_for_tracking as t_bin
    from gaus_slam_tpu_torch.render import render_tracking as t_render

    ds, jcam, jgm = _scene()
    jo, tcam, to = _ops(ds, jcam)
    pre = _rel_w2c(ds, 2, 1)
    jpose = j_init_pose(_rel_w2c(ds, 1))
    jcache = j_bin(jgm, jcam.replace_w2c(jnp.asarray(pre) @ jpose.w2c), jo)

    def jloss(q, t):
        out = j_render(jcache, q, t, jcam, jo, pre_w2c=jnp.asarray(pre))
        return jnp.sum(out[:, :4] * out[:, 4:5]), out

    (jl, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jpose.quat, jpose.trans)
    tgm = convert.gaussian_map_from_numpy(jgm, device="cpu")
    tpose = convert.pose_from_numpy(jpose, device="cpu")
    pre_t = torch.as_tensor(pre)
    tcache = t_bin(tgm, tcam.replace_w2c(pre_t @ tpose.w2c), to)
    q = tpose.quat.clone().requires_grad_()
    t = tpose.trans.clone().requires_grad_()
    tout = t_render(tcache, q, t, tcam, to, pre_w2c=pre_t)
    torch.sum(tout[:, :4] * tout[:, 4:5]).backward()
    # relative to each channel's scale: 1e-4, and 2e-3 on the channels
    # built on SA's ill-conditioned fusion weight (depth, middepth,
    # distortion: ROADMAP queue 3); integer channels on < 0.5% of pixels
    jo_np, to_np = np.asarray(jout), tout.detach().numpy()
    for c in range(13):
        scale = np.abs(jo_np[:, c]).max() + 1e-6
        tol = 2e-3 if c in (3, 8, 9) else 1e-4
        assert np.abs(to_np[:, c] - jo_np[:, c]).max() <= tol * scale, c
    assert np.mean(to_np[:, 13:] != jo_np[:, 13:]) < 5e-3
    for tg, g in ((q.grad, jg[0]), (t.grad, jg[1])):
        np.testing.assert_allclose(tg.numpy(), np.asarray(g), rtol=1e-3,
                                   atol=1e-3 * np.abs(np.asarray(g)).max())


def _track_cfgs():
    from gaus_slam_tpu.models.frame import LrSchedule as JLr
    from gaus_slam_tpu.slam.steps import TrackConfig as JTrack
    from gaus_slam_tpu_torch.models.frame import LrSchedule as TLr
    from gaus_slam_tpu_torch.slam.steps import TrackConfig as TTrack

    kw = dict(num_iters=8, converged_th=-1.0, betas=(0.7, 0.99))
    return (JTrack(rot_sched=JLr(1e-4, 0.0, 8), trans_sched=JLr(5e-4, 0.0, 8),
                   **kw),
            TTrack(rot_sched=TLr(1e-4, 0.0, 8), trans_sched=TLr(5e-4, 0.0, 8),
                   **kw))


def _exposures(device="cpu"):
    import jax.numpy as jnp

    from gaus_slam_tpu.models.frame import init_exposure as j_exp
    from gaus_slam_tpu_torch.models.frame import init_exposure as t_exp

    je = j_exp()._replace(gain=jnp.float32(1.1), bias=jnp.float32(-0.05))
    te = t_exp(device)._replace(gain=torch.tensor(1.1),
                                bias=torch.tensor(-0.05))
    fe = np.asarray([0.95, 0.02], np.float32)
    return je, te, fe


@pytest.mark.parametrize("exposure", [False, True], ids=["plain", "exposure"])
def test_backend_tracking_step_matches_jax(exposure):
    """One step of the submap transform under a fixed frame-in-submap
    pose, from a transform 2 cm off, through the pair cache and
    pre_w2c; with the composed, detached exposure."""
    import jax.numpy as jnp

    from gaus_slam_tpu.models.frame import init_pose as j_init_pose
    from gaus_slam_tpu.slam.loss import LossConfig as JLoss
    from gaus_slam_tpu.slam.steps import backend_tracking_step as j_step
    from gaus_slam_tpu_torch.slam.loss import LossConfig as TLoss
    from gaus_slam_tpu_torch.slam.steps import backend_tracking_step as t_step

    ds, jcam, jgm = _scene()
    jo, tcam, to = _ops(ds, jcam)
    jgt, tgt = _tiles(ds, 2, jo.grid, to.grid)
    frame_w2c = _rel_w2c(ds, 2, 1)
    tf0 = _rel_w2c(ds, 1)
    tf0[:3, 3] += np.asarray([0.02, -0.01, 0.01], np.float32)
    jt, tt = _track_cfgs()
    je, te, fe = _exposures()
    jkw = tkw = {}
    if exposure:
        jkw = dict(exposure=je, frame_exp=jnp.asarray(fe))
        tkw = dict(exposure=te, frame_exp=torch.as_tensor(fe))
    jpose = j_init_pose(tf0)
    jp, jaux = j_step(jgm, jpose, jnp.asarray(frame_w2c), jgt, jcam, jo, jt,
                      JLoss(enable_exposure=exposure), **jkw)
    tp, taux = t_step(convert.gaussian_map_from_numpy(jgm, device="cpu"),
                      convert.pose_from_numpy(jpose, device="cpu"),
                      torch.as_tensor(frame_w2c), tgt, tcam, to, tt,
                      TLoss(enable_exposure=exposure), **tkw)
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(tp.w2c.numpy(), np.asarray(jp.w2c), rtol=0,
                               atol=5e-5)
    assert tp.step == int(jp.step) == 1
    assert np.abs(tp.w2c.numpy() - tf0).max() > 1e-5     # the pose moved


def test_ba_step_and_mapping_with_frame_exposure_match_jax():
    """ba_step (a mapping step at frame_w2c @ transform, the transform's
    step advanced, the exposure stepped) and mapping_step with the frame's
    frozen exposure composed in, exposure on."""
    import jax.numpy as jnp

    from gaus_slam_tpu.models.frame import LrSchedule as JLr
    from gaus_slam_tpu.models.frame import init_pose as j_init_pose
    from gaus_slam_tpu.slam.loss import LossConfig as JLoss
    from gaus_slam_tpu.slam.steps import MapConfig as JMap
    from gaus_slam_tpu.slam.steps import ba_step as j_ba
    from gaus_slam_tpu.slam.steps import mapping_step as j_map
    from gaus_slam_tpu_torch.models.frame import LrSchedule as TLr
    from gaus_slam_tpu_torch.slam.loss import LossConfig as TLoss
    from gaus_slam_tpu_torch.slam.steps import MapConfig as TMap
    from gaus_slam_tpu_torch.slam.steps import ba_step as t_ba
    from gaus_slam_tpu_torch.slam.steps import mapping_step as t_map

    ds, jcam, jgm = _scene()
    jo, tcam, to = _ops(ds, jcam)
    jgt, tgt = _tiles(ds, 2, jo.grid, to.grid)
    lrs = (("opacity_lr", 0.05), ("rgb_lr", 0.0025), ("rotation_lr", 0.001),
           ("scaling_lr", 0.001), ("xyz_lr", 0.0001))
    je, te, fe = _exposures()
    tgm = convert.gaussian_map_from_numpy(jgm, device="cpu")
    w2c = _rel_w2c(ds, 2)
    jm, jex, _ = j_map(jgm, jnp.asarray(w2c), jgt, je, jnp.bool_(True),
                       JLr(0.005, 0.0001, 60), jcam, jo, JMap(lrs=lrs),
                       JLoss(enable_exposure=True), frame_exp=jnp.asarray(fe))
    tm, tex, _ = t_map(tgm, torch.as_tensor(w2c), tgt, te, True,
                       TLr(0.005, 0.0001, 60), tcam, to, TMap(lrs=lrs),
                       TLoss(enable_exposure=True),
                       frame_exp=torch.as_tensor(fe))
    np.testing.assert_allclose([float(tex.gain), float(tex.bias)],
                               [float(jex.gain), float(jex.bias)], rtol=0,
                               atol=1e-6)
    assert abs(float(tex.gain) - 1.1) > 1e-3
    _assert_step_close(tm, jm)

    jpose = j_init_pose(np.eye(4, dtype=np.float32))
    fw = _rel_w2c(ds, 2)
    jb, jbp, jbe, _ = j_ba(jgm, jpose, jnp.asarray(fw), jgt, je, jcam, jo,
                           JMap(lrs=lrs), JLoss(enable_exposure=True),
                           JLr(0.005, 0.0001, 60), frame_exp=jnp.asarray(fe))
    tb, tbp, tbe, _ = t_ba(tgm, convert.pose_from_numpy(jpose, "cpu"),
                           torch.as_tensor(fw), tgt, te, tcam, to,
                           TMap(lrs=lrs), TLoss(enable_exposure=True),
                           TLr(0.005, 0.0001, 60),
                           frame_exp=torch.as_tensor(fe))
    assert tbp.step == int(jbp.step) == 1
    np.testing.assert_array_equal(tbp.w2c.numpy(), np.asarray(jbp.w2c))
    np.testing.assert_allclose([float(tbe.gain), float(tbe.bias)],
                               [float(jbe.gain), float(jbe.bias)], rtol=0,
                               atol=1e-6)
    _assert_step_close(tb, jb)


def _assert_step_close(tgm, jgm):
    """Maps after one Adam step from the same map: every parameter within
    2 * lr (Adam's first step moves each by +-lr whatever the gradient's
    size), and 90% of them within 2e-3 relative, as
    tests/test_torch_frontend.py holds maps. The quaternions are held to
    the first bound only: the component along a wall's normal gets a
    rounding-level gradient, whose sign, and so the step's, differs
    between the packages on ~11% of them at this frame."""
    n = int(np.asarray(jgm.n_active))
    assert int(tgm.n_active) == n
    for f, lr in LRS.items():
        a = np.asarray(getattr(jgm.params, f))[:n]
        b = getattr(tgm.params, f).numpy()[:n]
        assert np.abs(a - b).max() <= 2 * lr, f
        rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-2)
        assert f == "quats" or np.mean(rel > 2e-3) < 0.1, f


@pytest.fixture(scope="module")
def submaps():
    ds = _dataset()
    return ds, [_submap(ds, 0, 0), _submap(ds, 1, 3), _submap(ds, 2, 6)]


def test_localmaps_match_jax(submaps):
    """Descriptor matrix, covisibility ranking and the time-ordered
    trajectory of converted LocalMaps."""
    from gaus_slam_tpu.models.frame import init_pose as j_init_pose
    from gaus_slam_tpu.models.submap import Localmaps as JLms
    from gaus_slam_tpu_torch.models.submap import Localmaps as TLms

    ds, lms = submaps
    jl, tl = JLms(), TLms()
    for i, lm in enumerate(lms):
        tlm = convert.localmap_from_jax(lm, "cpu")
        init = _rel_w2c(ds, 3 * i)
        lm_copy = _copy_jax_lm(lm)
        lm_copy.transform = j_init_pose(init)
        tlm.start_optimizer(init, device="cpu")
        jl.add_localmap(lm_copy)
        tl.add_localmap(tlm)
    np.testing.assert_array_equal(tl.map_descs, np.asarray(jl.map_descs))
    for i in range(len(lms)):
        assert tl.query_covisable(i, 2) == jl.query_covisable(i, 2)
    jw, tw = jl.get_w2cs(), tl.get_w2cs()
    assert len(tw) == len(jw) == 10
    np.testing.assert_allclose(np.stack(tw), np.stack(jw), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.stack(tl.get_gt_w2cs()),
                                  np.stack(jl.get_gt_w2cs()))


def _copy_jax_lm(lm):
    import copy

    return copy.copy(lm)


def _backends(ds, **tpu):
    from gaus_slam_tpu.slam.backend import Backend as JBackend
    from gaus_slam_tpu_torch.slam.backend import Backend as TBackend

    cfg = _config(ds, **tpu)
    return (JBackend(cfg, backend="interpret"),
            TBackend(cfg, backend="interpret", device="cpu"))


def _assert_backends_equal(tb, jb, map_atol=1e-6):
    assert list(tb.task_queue) == list(jb.task_queue.queue)
    assert tb.covis_idxs == jb.covis_idxs
    assert tb.rng.getstate() == jb.rng.getstate()
    assert tb.map.capacity == jb.map.capacity
    assert (tb._peak_hist, tb.n_active_host, tb.cur_lmid) == \
        (jb._peak_hist, jb.n_active_host, jb.cur_lmid)
    n = int(jb.map.n_active)
    assert int(tb.map.n_active) == n
    np.testing.assert_array_equal(tb.map.active.numpy(),
                                  np.asarray(jb.map.active))
    for f, p in zip(tb.map.params._fields, tb.map.params):
        np.testing.assert_allclose(p.numpy(), np.asarray(
            getattr(jb.map.params, f)), rtol=0, atol=map_atol, err_msg=f)
    for tlm, jlm in zip(tb.local_maps, jb.local_maps):
        np.testing.assert_allclose(tlm.get_w2c.numpy(),
                                   np.asarray(jlm.get_w2c), rtol=0, atol=1e-6)


@pytest.mark.parametrize("which", ["first", "later"])
def test_process_localmap_matches_jax(submaps, which):
    """One merge from identical state (multi_process=True: the queue is
    filled, not drained). The later merge runs through the capacity fit,
    the transfer, the opacity cap, covisibility and the five task blocks."""
    ds, lms = submaps
    jb, tb = _backends(ds)
    if which == "later":
        for lm in lms[:2]:
            jb.process_localmap(_copy_jax_lm(lm), multi_process=True)
        vars(tb).update(convert.backend_state_from_jax(jb, "cpu"))
        lm = lms[2]
    else:
        lm = lms[0]
    tb.process_localmap(convert.localmap_from_jax(lm, "cpu"),
                        multi_process=True)
    jb.process_localmap(_copy_jax_lm(lm), multi_process=True)
    _assert_backends_equal(tb, jb)
    kinds = [t[0] for t in tb.task_queue]
    if which == "later":
        assert "prune" in kinds and "tracking" in kinds and tb.covis_idxs
        assert tb.bucket_flips == getattr(jb, "bucket_flips", 0) >= 1


# merge-peak histories (the first entry is the first donor) and the
# capacity bucket of the map before _fit_capacity
CAPACITY_CASES = {
    "first-flip": ([3000, 6500], 4096, 6500),
    "steady": ([3000, 6500, 7000, 7600], 12288, 7600),
    "fast-growth": ([3000, 6500, 12000, 18000, 25000], 16384, 25000),
    "flat": ([3000, 9000, 9100, 9050, 9100], 12288, 9100),
    "shrink-held": ([3000, 9000, 9500], 16384, 7000),
    "shrink-to-peak": ([3000, 9000, 9500], 16384, 2000),
    "shrink": ([3000, 3100, 3200], 32768, 1500),
}


@pytest.mark.parametrize("case", sorted(CAPACITY_CASES))
def test_capacity_policy_matches_jax(case):
    """_merge_horizon and _fit_capacity on the same peak history and
    map: the same horizon, bucket and flip."""
    from gaus_slam_tpu.models import gaussians as JG
    from gaus_slam_tpu_torch.models import gaussians as TG

    hist, cap, needed = CAPACITY_CASES[case]
    jb, tb = _backends(_dataset())
    jb.map, tb.map = JG.empty_map(cap), TG.empty_map(cap, "cpu")
    jb._peak_hist, tb._peak_hist = list(hist), list(hist)
    h = tb._merge_horizon()
    assert h == jb._merge_horizon()
    jb._fit_capacity(needed, horizon=h)
    tb._fit_capacity(needed, horizon=h)
    assert tb.map.capacity == jb.map.capacity
    assert tb.bucket_flips == getattr(jb, "bucket_flips", 0)


def test_drain_matches_jax(submaps):
    """Two merges, each queue drained (num_ba_iters 4: fused mapping
    batches, the prune and the tracking tasks), from identical state
    before each merge: the same queue decisions and RNG draws, submap
    transforms within 5e-5, the map's size equal."""
    ds, lms = submaps
    jb, tb = _backends(ds)
    for lm in lms[:2]:
        vars(tb).update(convert.backend_state_from_jax(jb, "cpu"))
        tb.process_localmap(convert.localmap_from_jax(lm, "cpu"))
        jb.process_localmap(_copy_jax_lm(lm))
        assert tb.rng.getstate() == jb.rng.getstate()
        assert not tb.task_queue and jb.task_queue.empty()
        assert tb.n_active_host == jb.n_active_host
        assert tb.map.capacity == jb.map.capacity
        for tlm, jlm in zip(tb.local_maps, jb.local_maps):
            assert tlm.mapping_times == jlm.mapping_times
            np.testing.assert_allclose(tlm.get_w2c.numpy(),
                                       np.asarray(jlm.get_w2c), rtol=0,
                                       atol=5e-5)
    assert int(tb.map.n_active) == int(jb.map.n_active)


@pytest.mark.parametrize("knob", ["gs_densify", "save_ckpt", "backend_device",
                                  "mesh_devices"])
def test_backend_refuses_multi_device_and_unported_knobs(knob, tmp_path,
                                                        capsys):
    """The placement knobs resolve as in the JAX package: "auto" stays on
    the one device; tpu.backend_device past the attached devices is
    printed as ignored and the backend stays colocated (JAX backend.py:
    80-82); a BA group of more devices than attached raises ValueError
    (mesh_from_config). backend.save_ckpt is accepted, and a checkpoint
    of the backend writes meta.json; backend.gs_densify is accepted
    (ported) and turns on the mapping step's densify statistics."""
    from gaus_slam_tpu_torch.parallel import devices_from_config
    from gaus_slam_tpu_torch.slam.backend import Backend

    cfg = _config(_dataset())
    auto = dict(cfg, tpu=dict(cfg["tpu"], backend_device="auto",
                              mesh_devices="auto"))
    assert devices_from_config(auto, "cpu") is None
    be = Backend(auto, device="cpu")
    assert be.device == torch.device("cpu") and be.stream is None
    if knob == "save_ckpt":
        import json
        import queue

        from gaus_slam_tpu_torch.slam.frontend import Frontend
        from gaus_slam_tpu_torch.utils.checkpoint import save_run_state

        cfg["backend"]["save_ckpt"] = True
        be = Backend(cfg, device="cpu")
        fe = Frontend(cfg, queue.Queue(), device="cpu")
        fe.map = convert.gaussian_map_from_numpy(_scene()[2], "cpu")
        save_run_state(str(tmp_path / "ckpt"), fe, be, next_frame_idx=3)
        meta = json.loads((tmp_path / "ckpt" / "meta.json").read_text())
        assert meta["next_frame_idx"] == 3 and meta["localmaps"] == []
        return
    if knob == "gs_densify":
        cfg["backend"][knob] = True
        be = Backend(cfg, device="cpu")
        assert be.gs_densify and be.sys.mcfg.gs_stats
        return
    if knob == "backend_device":
        cfg["tpu"][knob] = "1"
        capsys.readouterr()
        be = Backend(cfg, device="cpu")
        assert "tpu.backend_device=1 ignored" in capsys.readouterr().out
        assert be.device == torch.device("cpu") and be.stream is None
        return
    cfg["tpu"][knob] = 2
    with pytest.raises(ValueError, match="devices attached"):
        devices_from_config(cfg, "cpu")
