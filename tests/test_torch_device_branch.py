"""The port's steps decide on the device, as the JAX package's do.

* ``Binning.slab_scatter_grads`` computes both reductions and selects by
  the device overflow flag (JAX: ``lax.cond``; on a card inside a
  captured step an IF node runs one, tests/test_torch_cond.py): equal to
  the JAX package
  (1e-5, as tests/test_torch_reduce.py) and bit-equal to a copy of the
  earlier host-branch code (the sort-based slab, the run path), with and
  without overflow.
* ``tracking_loop``'s early exit runs on the device (JAX: the
  ``lax.while_loop`` carry) and the host stops ``lag`` iterations late:
  the iteration count and the host step equal JAX's, the pose is within
  test_torch_steps.py's 5e-5 of JAX's, and bit-equal across lags 0-2 and
  to a copy of the earlier early-stop loop (the host read of the
  convergence test); also through a tracking_refresh pair of loops, the
  second starting from the first's step.
* The constants that were built from host data per call are bit-equal
  to the tensors they replace.
* No host read and no host-data copy to the device inside a step: the
  reads a card would wait on (``Tensor.__bool__`` / ``__float__`` /
  ``__int__`` / ``item`` / ``tolist`` / ``cpu`` / ``numpy``, and
  ``torch.tensor`` / ``torch.as_tensor`` given a device) raise when the
  caller is one of the step's modules. Exempt: the lagged tracking
  loop's one lagged read (``_LaggedFlag.read``), and the constant caches'
  first fill, warmed up before the check. The one-program tracking loop
  tests its condition in slam/programs.py (on the CPU the host loop over
  ``while_cond_plain``; on a card ``while_cond`` inside the graph). The same check raises on a copy of
  the earlier ``slab_scatter_grads``, so it does see a read.
"""
import contextlib
import inspect
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

import gaus_slam_tpu_torch
from gaus_slam_tpu_torch.ops import binning as TB
from gaus_slam_tpu_torch.ops import consts
from test_torch_reduce import binnings
from test_torch_steps import _tiny_scene


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the earlier code, copied: host branch on the overflow flag


def _parent_slab_reduce(b, pair_grads, n, d_max):
    r, c = pair_grads.shape
    total = d_max * n
    keys = torch.cat([b.pair_slab, b.slab_tail])
    pad = keys.shape[0] - r
    perm = torch.sort(keys, stable=True).indices
    grads_p = torch.where(b.pair_ok[:, None], pair_grads,
                          torch.zeros((), device=pair_grads.device))
    grads_p = torch.nn.functional.pad(grads_p, (0, 0, 0, pad))
    slab = grads_p[perm[:total]]
    return slab.reshape(d_max, n, c).sum(dim=0)


def _parent_run_reduce(b, pair_grads, n, d_max, backend):
    r, _ = pair_grads.shape
    dev = pair_grads.device
    if b.red_perm is not None and b.red_perm.shape[0]:
        keys_sorted, perm = b.red_keys, b.red_perm.long()
    else:
        keys = torch.where(b.pair_ok, b.pair_gauss,
                           torch.full_like(b.pair_gauss, n))
        keys_sorted, perm = torch.sort(keys, stable=True)
    grads_sorted = torch.where(b.pair_ok[:, None], pair_grads,
                               torch.zeros((), device=dev))[perm]
    acc = TB._segmented_scan(grads_sorted, keys_sorted, d_max)
    pos = torch.clamp(torch.cumsum(b.counts, 0) - 1, 0,
                      r - 1).to(torch.int32)
    out = TB._land(acc, pos, backend)
    return torch.where((b.counts > 0)[:, None], out,
                       torch.zeros((), device=dev))


def _parent_slab_scatter_grads(self, pair_grads, n, d_max=None,
                               backend=None):
    d_max = d_max if d_max is not None else self.num_tiles_touched
    if bool(self.overflow):
        return _parent_slab_reduce(self, pair_grads, n, d_max)
    return _parent_run_reduce(self, pair_grads, n, d_max, backend)


@pytest.mark.parametrize("backend", [None, "interpret"])
@pytest.mark.parametrize("reduce_perm", [True, False])
@pytest.mark.parametrize("r_max,overflow", [(2048, False), (384, True)])
def test_slab_scatter_grads_on_device_branch(r_max, overflow, reduce_perm,
                                            backend):
    import jax.numpy as jnp

    n = 256
    jb, tb, rng = binnings(0, n, r_max)
    if not reduce_perm:
        tb = tb._replace(red_keys=None, red_perm=None)
    assert bool(tb.overflow) == overflow == bool(jb.overflow)
    g = torch.tensor(rng.normal(size=(r_max, 24)).astype(np.float32))
    got = tb.slab_scatter_grads(g, n, backend=backend)
    ref = np.asarray(jb.slab_scatter_grads(jnp.asarray(g.numpy()), n,
                                           backend="interpret"))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    old = _parent_slab_scatter_grads(tb, g, n, backend=backend)
    assert torch.equal(got, old)
    # each reduction alone (on the padding-zeroed rows it takes), bit for
    # bit against its earlier form
    g0 = torch.where(tb.pair_ok[:, None], g, torch.zeros(()))
    assert torch.equal(tb._slab_reduce(g0, n, 4),
                       _parent_slab_reduce(tb, g, n, 4))
    assert torch.equal(tb._run_reduce(g0, n, 4, backend),
                       _parent_run_reduce(tb, g, n, 4, backend))


def test_slab_reduce_padded_budget():
    """A budget above the slab (r_max > d_max * n): pair_slab runs past
    the slab's slots; the scatter lands the same rows as the sort."""
    n = 64
    _, tb, rng = binnings(2, n, 2048)
    assert tb.pair_slab.shape[0] > 4 * n and tb.slab_tail.shape[0] == 0
    g = torch.tensor(rng.normal(size=(2048, 24)).astype(np.float32))
    g0 = torch.where(tb.pair_ok[:, None], g, torch.zeros(()))
    assert torch.equal(tb._slab_reduce(g0, n, 4),
                       _parent_slab_reduce(tb, g, n, 4))


# ---------------------------------------------------------------------------
# constants made once: bit-equal to the per-call tensors they replace


def test_constants_bit_equal():
    from gaus_slam_tpu_torch.ops import preprocess as TP
    from gaus_slam_tpu_torch.ops.camera import (Camera, opengl_projection,
                                                world_to_pix3)
    from gaus_slam_tpu_torch.ops.se3 import _bottom_row
    from gaus_slam_tpu_torch.slam import loss as TL
    from gaus_slam_tpu_torch.slam.steps import (_coarse_map_phases,
                                                _coarse_map_phases_host)

    w2c = torch.tensor([[0.96, -0.28, 0.0, 0.3], [0.28, 0.96, 0.0, -0.1],
                        [0.0, 0.0, 1.0, 1.7], [0.0, 0.0, 0.0, 1.0]])
    cam = Camera(340, 600, 301.7, 299.3, 299.1, 170.4, w2c,
                 near=0.013, far=97.0)
    w, h, near, far = cam.width, cam.height, cam.near, cam.far
    proj = torch.tensor([
        [2 * cam.fx / w, 0.0, -(w - 2 * cam.cx) / w, 0.0],
        [0.0, 2 * cam.fy / h, -(h - 2 * cam.cy) / h, 0.0],
        [0.0, 0.0, far / (far - near), -(far * near) / (far - near)],
        [0.0, 0.0, 1.0, 0.0]], dtype=torch.float32)
    n2p = torch.tensor([[w / 2.0, 0.0, 0.0, (w - 1) / 2.0],
                        [0.0, h / 2.0, 0.0, (h - 1) / 2.0],
                        [0.0, 0.0, 0.0, 1.0]], dtype=torch.float32)
    for got, want in ((opengl_projection(cam), proj),
                      (world_to_pix3(cam), n2p @ (proj @ w2c))):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert opengl_projection(cam) is opengl_projection(cam)  # made once
    c2 = TP.CUTOFF * TP.CUTOFF
    assert torch.equal(consts.constant((c2, c2, -1.0), torch.float32, "cpu"),
                       torch.tensor([c2, c2, -1.0], dtype=torch.float32))
    like = torch.zeros(5, 3, 4)
    assert torch.equal(_bottom_row(like), torch.tensor(
        [0.0, 0.0, 0.0, 1.0]).expand(5, 1, 4))
    big = consts.constant(3.4e38, torch.float32, "cpu")
    assert big.shape == () and torch.equal(
        big, torch.tensor(3.4e38, dtype=torch.float32))
    x = torch.tensor([3.0, 1.0, 2.0, 7.0])
    m = torch.tensor([True, False, True, True])
    assert float(TL._masked_median(x, m)) == 3.0
    grid = TB.TileGrid(38, 22, 16, 16)
    ids, valid = _coarse_map_phases(grid, 3, "cpu")
    ids_h, valid_h = _coarse_map_phases_host(grid, 3)
    assert torch.equal(ids, torch.as_tensor(ids_h))
    assert torch.equal(valid, torch.as_tensor(valid_h))
    assert ids.dtype == torch.int32 and valid.dtype == torch.bool
    rank, base, _ = TB.phase_tables(grid, 3)
    key = ("phase_tables", grid, 3, False)
    assert torch.equal(consts.cached(key + ("rank",),
                                     lambda: rank.astype(np.int64), "cpu"),
                       torch.as_tensor(rank, dtype=torch.long))
    from gaus_slam_tpu_torch.models.frame import init_exposure
    e = init_exposure("cpu")
    assert torch.equal(e.gain, torch.tensor(1.0)) and torch.equal(
        e.bias, torch.tensor(0.0))


# ---------------------------------------------------------------------------
# the tracking loop: convergence on the device, the host lag behind


def _early_stop_loop(cache, pose0, gt_tiled, cam_proj, opts, tcfg, lcfg):
    """The earlier tracking loop's iterations: the convergence test read
    on the host after every iteration. Returns (pose, iters, loss,
    depth_l1)."""
    from gaus_slam_tpu_torch.models.frame import pose_adam_step
    from gaus_slam_tpu_torch.render import (render_tracking,
                                            track_coarse_budget)
    from gaus_slam_tpu_torch.slam.loss import tracking_loss
    from gaus_slam_tpu_torch.slam.steps import _coarse_tile_ids

    pose = pose0
    st = {"k": 0, "conv": 0, "loss": None, "depth_l1": None}

    def run(kmax, tile_ids, gt_sub, pair_hi):
        nonlocal pose
        while st["k"] < kmax and not st["conv"] > 3:
            quat = pose.quat.detach().requires_grad_()
            trans = pose.trans.detach().requires_grad_()
            out = render_tracking(cache, quat, trans, cam_proj, opts,
                                  tile_ids=tile_ids, pair_hi=pair_hi)
            loss, aux = tracking_loss(out, gt_sub, lcfg)
            g_q, g_t = torch.autograd.grad(loss, (quat, trans))
            new_pose = pose_adam_step(
                pose._replace(quat=quat.detach(), trans=trans.detach()),
                g_q, g_t, tcfg.rot_sched, tcfg.trans_sched, tcfg.betas)
            delta = float(torch.linalg.norm(new_pose.trans - pose.trans))
            st["conv"] = st["conv"] + 1 if delta < tcfg.converged_th else 0
            pose = new_pose
            st["k"] += 1
            st["loss"], st["depth_l1"] = loss.detach(), aux["depth_l1"]

    consumed = 0
    levels = tcfg.levels() if opts.backend != "reference" else ()
    for it_l, s_l in levels:
        n_l = min(it_l, tcfg.num_iters - consumed)
        if n_l <= 0 or s_l <= 1:
            continue
        ids = _coarse_tile_ids(opts.grid, s_l, gt_tiled.device)
        run(consumed + n_l, ids, gt_tiled[ids.long()],
            track_coarse_budget(cache.raw_t.shape[1], s_l))
        consumed += n_l
    run(tcfg.num_iters, None, gt_tiled, None)
    return pose, st["k"], st["loss"], st["depth_l1"]


def _assert_poses_equal(a, b):
    for f in ("quat", "trans", "m_q", "v_q", "m_t", "v_t"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.step == b.step


# converges at 32x32 before num_iters (15 of 20 under "reference", 17 of
# 20 with a coarse level under "interpret")
TRACK = dict(num_iters=20, converged_th=5e-4, lr=(4e-4, 8e-5, 5e-4, 1e-4))


def _track_cfgs(num_iters=TRACK["num_iters"], **kw):
    from gaus_slam_tpu.models.frame import LrSchedule as JLr
    from gaus_slam_tpu.slam.steps import TrackConfig as JTrack
    from gaus_slam_tpu_torch.models.frame import LrSchedule as TLr
    from gaus_slam_tpu_torch.slam.steps import TrackConfig as TTrack

    r0, r1, t0, t1 = TRACK["lr"]
    mk = dict(num_iters=num_iters, converged_th=TRACK["converged_th"], **kw)
    n = TRACK["num_iters"]
    return (JTrack(rot_sched=JLr(r0, r1, n), trans_sched=JLr(t0, t1, n), **mk),
            TTrack(rot_sched=TLr(r0, r1, n), trans_sched=TLr(t0, t1, n), **mk))


@pytest.fixture(scope="module")
def track_case():
    """The tiny scene of test_torch_steps.py, frame 2 tracked from frame
    1's pose, in both packages, with the JAX loop's results under the
    reference backend: one loop of 20, and a tracking_refresh pair (6,
    re-bin at the new pose, then 14 from the first's step)."""
    import jax.numpy as jnp

    from gaus_slam_tpu.models.frame import init_pose as j_init_pose
    from gaus_slam_tpu.ops import binning as JB
    from gaus_slam_tpu.ops.composite_ref import frame_to_tiles as j_tiles
    from gaus_slam_tpu.render import RenderOptions as JOpts
    from gaus_slam_tpu.render import bin_for_tracking as j_bin
    from gaus_slam_tpu.slam.loss import LossConfig as JLoss
    from gaus_slam_tpu.slam.steps import tracking_loop as j_track
    from gaus_slam_tpu_torch import convert
    from gaus_slam_tpu_torch.ops.camera import camera_from_intrinsics as t_cam
    from gaus_slam_tpu_torch.ops.composite_ref import frame_to_tiles as t_tiles

    ds, jcam, jgm = _tiny_scene()
    h, w = jcam.height, jcam.width
    c2w0, (color, depth, _, _) = ds[0][3], ds[2]
    init = np.linalg.inv(np.linalg.inv(c2w0) @ ds[1][3]).astype(np.float32)
    kw = dict(pair_budget_factor=1.35, max_tiles_per_gaussian=4)
    jo = JOpts(grid=JB.make_grid(jcam, 16, 16), backend="reference", **kw)
    jpose = j_init_pose(init)
    jgt = j_tiles(jnp.asarray(color / 255.0), jnp.asarray(depth), jo.grid)
    jt, _ = _track_cfgs()
    jcache = j_bin(jgm, jcam.replace_w2c(jpose.w2c), jo)
    jp, jaux = j_track(jcache, jpose, jgt, jcam, jo, jt, JLoss())
    jt1, _ = _track_cfgs(num_iters=6)
    jp1, jaux1 = j_track(jcache, jpose, jgt, jcam, jo, jt1, JLoss())
    jcache2 = j_bin(jgm, jcam.replace_w2c(jp1.w2c), jo)
    jt2, _ = _track_cfgs(num_iters=14)
    jp2, jaux2 = j_track(jcache2, jp1, jgt, jcam, jo, jt2, JLoss())

    tcam = t_cam(h, w, ds.intrinsics, np.eye(4), device="cpu")
    return dict(
        tcam=tcam, kw=kw, tgm=convert.gaussian_map_from_numpy(jgm, "cpu"),
        tpose=convert.pose_from_numpy(jpose, device="cpu"),
        tgt=t_tiles(torch.tensor((color / 255.0).astype(np.float32)),
                    torch.tensor(depth), TB.make_grid(tcam, 16, 16)),
        jax=(np.asarray(jp.w2c), int(jaux["iters"]), int(jp.step),
             float(jaux["loss"])),
        jax_refresh=(int(jaux1["iters"]), int(jp1.step), np.asarray(jp2.w2c),
                     int(jaux2["iters"]), int(jp2.step)))


def _port_opts(case, backend):
    from gaus_slam_tpu_torch.render import RenderOptions as TOpts

    return TOpts(grid=TB.make_grid(case["tcam"], 16, 16), backend=backend,
                 **case["kw"])


@pytest.mark.parametrize("lag", [0, 1, 2])
def test_tracking_loop_converges_on_device_matches_jax(track_case, lag):
    from gaus_slam_tpu_torch.render import bin_for_tracking
    from gaus_slam_tpu_torch.slam.loss import LossConfig
    from gaus_slam_tpu_torch.slam.steps import tracking_loop

    c = track_case
    to = _port_opts(c, "reference")
    _, tt = _track_cfgs()
    cache = bin_for_tracking(c["tgm"], c["tcam"].replace_w2c(c["tpose"].w2c),
                             to)
    tp, aux = tracking_loop(cache, c["tpose"], c["tgt"], c["tcam"], to, tt,
                            LossConfig(), lag=lag)
    j_w2c, j_iters, j_step, j_loss = c["jax"]
    assert j_iters < TRACK["num_iters"]   # the schedule converges early
    assert isinstance(aux["iters"], torch.Tensor)
    assert int(aux["iters"]) == j_iters and tp.step == j_step
    np.testing.assert_allclose(float(aux["loss"]), j_loss, rtol=1e-4)
    np.testing.assert_allclose(tp.w2c.numpy(), j_w2c, rtol=0, atol=5e-5)
    # the host queued ``lag`` iterations past the stop, all masked
    assert aux["queued"] == min(j_iters + lag, TRACK["num_iters"])
    # bit-equal to the loop that reads the test on the host each time
    p, k, loss, dl1 = _early_stop_loop(cache, c["tpose"], c["tgt"],
                                       c["tcam"], to, tt, LossConfig())
    _assert_poses_equal(tp, p)
    assert k == int(aux["iters"])
    assert torch.equal(aux["loss"], loss)
    assert torch.equal(aux["depth_l1"], dl1)


@pytest.mark.parametrize("lag", [0, 1, 2])
def test_tracking_loop_lag_bit_equal_coarse(track_case, lag):
    """Under "interpret" (the stash path's plain versions) with a coarse
    level, whose convergence counter carries into the full-resolution
    level: every lag gives the early-stop loop's bits."""
    from gaus_slam_tpu_torch.render import bin_for_tracking
    from gaus_slam_tpu_torch.slam.loss import LossConfig
    from gaus_slam_tpu_torch.slam.steps import tracking_loop

    c = track_case
    to = _port_opts(c, "interpret")
    _, tt = _track_cfgs(coarse_levels=((6, 2),))
    cache = bin_for_tracking(c["tgm"], c["tcam"].replace_w2c(c["tpose"].w2c),
                             to, coarse_strides=(2,))
    tp, aux = tracking_loop(cache, c["tpose"], c["tgt"], c["tcam"], to, tt,
                            LossConfig(), compact_coarse=True, lag=lag,
                            want_view=True)
    p, k, loss, dl1 = _early_stop_loop(cache, c["tpose"], c["tgt"],
                                       c["tcam"], to, tt, LossConfig())
    assert 6 < k < TRACK["num_iters"]
    _assert_poses_equal(tp, p)
    assert int(aux["iters"]) == k
    assert aux["queued"] == min(k + lag, TRACK["num_iters"])
    assert torch.equal(aux["loss"], loss)
    assert torch.equal(aux["depth_l1"], dl1)
    assert torch.equal(aux["w2c"], p.w2c)


def test_tracking_refresh_carries_the_step(track_case):
    """The frontend's tracking_refresh: a loop of 6, a re-bin at its pose,
    then 14 more from the returned pose, whose host step sets the second
    loop's learning rates: the steps and counts equal JAX's."""
    from gaus_slam_tpu_torch.render import bin_for_tracking
    from gaus_slam_tpu_torch.slam.loss import LossConfig
    from gaus_slam_tpu_torch.slam.steps import tracking_loop

    c = track_case
    to = _port_opts(c, "reference")
    _, tt1 = _track_cfgs(num_iters=6)
    _, tt2 = _track_cfgs(num_iters=14)
    cache = bin_for_tracking(c["tgm"], c["tcam"].replace_w2c(c["tpose"].w2c),
                             to)
    p1, aux1 = tracking_loop(cache, c["tpose"], c["tgt"], c["tcam"], to, tt1,
                             LossConfig())
    cache2 = bin_for_tracking(c["tgm"], c["tcam"].replace_w2c(p1.w2c), to)
    p2, aux2 = tracking_loop(cache2, p1, c["tgt"], c["tcam"], to, tt2,
                             LossConfig())
    ji1, js1, jw2, ji2, js2 = c["jax_refresh"]
    assert (int(aux1["iters"]), p1.step) == (ji1, js1)
    assert (int(aux2["iters"]), p2.step) == (ji2, js2)
    assert ji2 < 14       # the second loop stops early
    np.testing.assert_allclose(p2.w2c.numpy(), jw2, rtol=0, atol=5e-5)
    q2, k2, _, _ = _early_stop_loop(cache2, p1, c["tgt"], c["tcam"], to, tt2,
                                    LossConfig())
    _assert_poses_equal(p2, q2)


def test_tracking_loop_without_early_exit_unchanged(track_case):
    """converged_th <= 0: every iteration runs, no flag is read."""
    from gaus_slam_tpu_torch.render import bin_for_tracking
    from gaus_slam_tpu_torch.slam.loss import LossConfig
    from gaus_slam_tpu_torch.slam.steps import tracking_loop

    c = track_case
    to = _port_opts(c, "reference")
    _, tt = _track_cfgs(num_iters=5)
    tt = tt._replace(converged_th=-1.0)
    cache = bin_for_tracking(c["tgm"], c["tcam"].replace_w2c(c["tpose"].w2c),
                             to)
    tp, aux = tracking_loop(cache, c["tpose"], c["tgt"], c["tcam"], to, tt,
                            LossConfig())
    p, k, loss, _ = _early_stop_loop(cache, c["tpose"], c["tgt"], c["tcam"],
                                     to, tt, LossConfig())
    _assert_poses_equal(tp, p)
    assert int(aux["iters"]) == k == 5 and aux["host_waits"] == 0
    assert torch.equal(aux["loss"], loss)


# ---------------------------------------------------------------------------
# no host read, no host-data copy inside a step

PKG = os.path.dirname(os.path.abspath(gaus_slam_tpu_torch.__file__))
STEP_FILES = ("ops/binning.py", "slam/steps.py", "render/__init__.py",
              "parallel/ba.py", "ops/preprocess.py", "ops/camera.py",
              "ops/se3.py", "slam/loss.py", "models/submap.py",
              "ops/consts.py")
WATCHED = {os.path.join(PKG, f) for f in STEP_FILES}
READS = ("__bool__", "__float__", "__int__", "item", "tolist", "cpu",
         "numpy")


class HostRead(AssertionError):
    pass


@contextlib.contextmanager
def no_host_reads():
    """Within: a device read or a host-data copy to a device by a step
    module raises HostRead, except in the tracking loop's lagged read."""
    from gaus_slam_tpu_torch.slam.steps import _LaggedFlag

    exempt = {_LaggedFlag.read.__code__}
    saved = []

    def watched(frame):
        # the package may have been imported through an unnormalized
        # path (a test that puts "tests/.." on sys.path)
        return (os.path.abspath(frame.f_code.co_filename) in WATCHED
                and frame.f_code not in exempt)

    def where(frame):
        path = os.path.abspath(frame.f_code.co_filename)
        return (f"{os.path.relpath(path, PKG)}:{frame.f_lineno} "
                f"{frame.f_code.co_name}")

    def guard_read(name):
        orig = getattr(torch.Tensor, name)

        def read(self, *a, **kw):
            f = sys._getframe(1)
            if watched(f):
                raise HostRead(f"host read Tensor.{name} at {where(f)}")
            return orig(self, *a, **kw)
        saved.append((torch.Tensor, name, orig))
        setattr(torch.Tensor, name, read)

    def guard_copy(name, pos):
        orig = getattr(torch, name)

        def make(*a, **kw):
            dev = kw.get("device", a[pos] if len(a) > pos else None)
            f = sys._getframe(1)
            if dev is not None and watched(f):
                raise HostRead(f"host data copied to {dev} by torch.{name} "
                               f"at {where(f)}")
            return orig(*a, **kw)
        saved.append((torch, name, orig))
        setattr(torch, name, make)

    for name in READS:
        guard_read(name)
    guard_copy("tensor", 99)      # device is keyword-only
    guard_copy("as_tensor", 2)
    try:
        yield
    finally:
        for obj, name, orig in reversed(saved):
            setattr(obj, name, orig)


@pytest.fixture(scope="module")
def step_scene():
    """A 48x64 port-only scene: the synthetic frame 0's map (capacity
    4096), frames 1-2 as targets, the stash path's plain versions."""
    from gaus_slam_tpu_torch.data.synthetic import SyntheticDataset
    from gaus_slam_tpu_torch.models.frame import LrSchedule, init_pose
    from gaus_slam_tpu_torch.ops.camera import camera_from_intrinsics
    from gaus_slam_tpu_torch.ops.composite_ref import frame_to_tiles
    from gaus_slam_tpu_torch.render import RenderOptions
    from gaus_slam_tpu_torch.slam.init_map import initialize_map
    from gaus_slam_tpu_torch.slam.loss import LossConfig
    from gaus_slam_tpu_torch.slam.steps import MapConfig, TrackConfig

    h, w = 48, 64
    ds = SyntheticDataset(height=h, width=w, num_frames=4)
    cam = camera_from_intrinsics(h, w, ds.intrinsics, np.eye(4),
                                 device="cpu")
    c2w0 = np.asarray(ds[0][3], np.float64)

    def frame(t):
        color, depth, _, c2w = ds[t]
        w2c = (np.linalg.inv(c2w) @ c2w0).astype(np.float32)
        return (torch.tensor((color / 255.0).astype(np.float32)),
                torch.tensor(np.asarray(depth, np.float32)),
                torch.tensor(w2c))

    c0, d0, w0 = frame(0)
    gm = initialize_map(4096, c0, d0, w0, cam)
    opts = RenderOptions(grid=TB.make_grid(cam, 16, 16), backend="interpret",
                         pair_budget_factor=1.35, max_tiles_per_gaussian=4)
    frames = [frame(t) for t in (1, 2)]
    gts = torch.stack([frame_to_tiles(c, d, opts.grid) for c, d, _ in frames])
    w2cs = torch.stack([m for _, _, m in frames])
    mcfg = MapConfig(lrs=(("opacity_lr", 0.05), ("rgb_lr", 0.0025),
                          ("rotation_lr", 0.001), ("scaling_lr", 0.001),
                          ("xyz_lr", 0.0001)))
    tcfg = TrackConfig(num_iters=8, converged_th=5e-4,
                       rot_sched=LrSchedule(4e-4, 8e-5, 8),
                       trans_sched=LrSchedule(5e-4, 1e-4, 8),
                       coarse_iters=3, coarse_stride=3)
    return dict(cam=cam, gm=gm, opts=opts, gts=gts, w2cs=w2cs, mcfg=mcfg,
                tcfg=tcfg, lcfg=LossConfig(ignore_outliers=True),
                pose=init_pose(w2cs[0], device="cpu"))


def _steps(sc):
    """{name: a callable running one step on the scene}."""
    from gaus_slam_tpu_torch.models.frame import LrSchedule, init_exposure
    from gaus_slam_tpu_torch.parallel import sharded_ba_step
    from gaus_slam_tpu_torch.render import bin_for_tracking
    from gaus_slam_tpu_torch.slam.steps import (backend_tracking_step,
                                                mapping_loop, mapping_step,
                                                tracking_loop)

    cam, gm, opts, gts, w2cs = (sc[k] for k in ("cam", "gm", "opts", "gts",
                                                "w2cs"))
    mcfg, tcfg, lcfg = sc["mcfg"], sc["tcfg"], sc["lcfg"]
    exp0 = init_exposure("cpu")
    sched = LrSchedule(0.0, 0.0, 1)
    # a budget cut below demand: the binning overflows
    tight = opts._replace(pair_cap=256)

    def tracking(lag=None):
        cache = bin_for_tracking(gm, cam.replace_w2c(sc["pose"].w2c), opts,
                                 coarse_strides=(3,))
        return tracking_loop(cache, sc["pose"], gts[0], cam, opts, tcfg, lcfg,
                             compact_coarse=True, want_view=True, lag=lag)

    return {
        "mapping_step": lambda: mapping_step(gm, w2cs[0], gts[0], exp0, False,
                                             sched, cam, opts, mcfg, lcfg),
        "mapping_step overflow": lambda: mapping_step(
            gm, w2cs[0], gts[0], exp0, False, sched, cam, tight, mcfg, lcfg),
        "mapping_loop x4": lambda: mapping_loop(
            gm, w2cs[[0, 1, 0, 1]], gts[[0, 1, 0, 1]], cam, opts, mcfg, lcfg),
        "mapping_loop x4 coarse 3": lambda: mapping_loop(
            gm, w2cs[[0, 1, 0, 1]], gts[[0, 1, 0, 1]], cam, opts, mcfg, lcfg,
            coarse_stride=3, phase0=2),
        "backend_tracking_step": lambda: backend_tracking_step(
            gm, sc["pose"], w2cs[1], gts[1], cam, opts, tcfg, lcfg),
        "sharded_ba_step": lambda: sharded_ba_step(
            [torch.device("cpu")] * 2, gm, w2cs, gts, cam, opts, mcfg, lcfg,
            weights=[1, 0]),
        "tracking_loop": tracking,
        "tracking_loop lagged": lambda: tracking(lag=1),
    }


STEP_NAMES = ("mapping_step", "mapping_step overflow", "mapping_loop x4",
              "mapping_loop x4 coarse 3", "backend_tracking_step",
              "sharded_ba_step", "tracking_loop", "tracking_loop lagged")


@pytest.mark.parametrize("name", STEP_NAMES)
def test_step_makes_no_host_read(step_scene, name):
    fn = _steps(step_scene)[name]
    want = fn()                 # warm-up: the constant caches fill
    with no_host_reads():
        got = fn()
    if name == "mapping_step overflow":
        assert bool(got[2]["overflow"])
    if name.startswith("tracking_loop"):
        assert got[0].step == want[0].step
    if name == "tracking_loop":
        # one program: the condition is tested where the loop runs (on a
        # card by while_cond inside the graph)
        assert got[1]["host_waits"] == 0
    if name == "tracking_loop lagged":
        assert 0 < got[1]["host_waits"] <= got[1]["queued"]


def test_host_read_check_sees_the_earlier_branch(step_scene, monkeypatch):
    """The earlier slab_scatter_grads, compiled as if it were binning.py's
    (its frames carry that file): the check raises on its flag read."""
    src = textwrap.dedent(inspect.getsource(_parent_slab_scatter_grads))
    ns = {"_parent_slab_reduce": _parent_slab_reduce,
          "_parent_run_reduce": _parent_run_reduce}
    exec(compile(src, TB.__file__, "exec"), ns)
    monkeypatch.setattr(TB.Binning, "slab_scatter_grads",
                        ns["_parent_slab_scatter_grads"])
    fn = _steps(step_scene)["mapping_step"]
    fn()
    with pytest.raises(HostRead, match="__bool__ at ops/binning.py"):
        with no_host_reads():
            fn()
