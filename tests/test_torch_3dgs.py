"""Port parity of the 3DGS render method (ops/preprocess_3dgs.py and the
render facade's "3dgs" dispatch), ops/knn.py and ops/sh.py against the
JAX package, on the same numpy-seeded inputs; the JAX side renders in
interpret mode, as its own tests do.

Tolerances: preprocess fields 1e-6 of each field's scale (float32 in
another operation order); renders 1e-4 of each channel's scale and
gradients 1e-3 relative L2 per parameter field, as in
test_torch_render.py (float32 sums in another order through the
compositor); knn 1e-6 relative; the face-on 3DGS-equals-2DGS case with
tests/test_3dgs.py's own bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaus_slam_tpu import render as JR
from gaus_slam_tpu.data.synthetic import SyntheticDataset
from gaus_slam_tpu.models import gaussians as JG
from gaus_slam_tpu.models.frame import init_pose as j_init_pose
from gaus_slam_tpu.ops import binning as JB
from gaus_slam_tpu.ops import knn as JK
from gaus_slam_tpu.ops import sh as JS
from gaus_slam_tpu.ops.camera import Camera as JCamera
from gaus_slam_tpu.ops.camera import camera_from_intrinsics as j_cam
from gaus_slam_tpu.ops.preprocess_3dgs import preprocess_3dgs as j_pre3
from gaus_slam_tpu.ops.preprocess_3dgs import scales_to_3d as j_s3d
from gaus_slam_tpu.ops.se3 import quat_to_rotmat as j_rotmat
from gaus_slam_tpu.slam.init_map import initialize_map as j_init_map
from gaus_slam_tpu_torch import convert
from gaus_slam_tpu_torch import render as TR
from gaus_slam_tpu_torch.models import gaussians as TG
from gaus_slam_tpu_torch.ops import binning as TB
from gaus_slam_tpu_torch.ops import knn as TK
from gaus_slam_tpu_torch.ops import sh as TS
from gaus_slam_tpu_torch.ops.camera import Camera as TCamera
from gaus_slam_tpu_torch.ops.camera import camera_from_intrinsics as t_cam
from gaus_slam_tpu_torch.ops.preprocess_3dgs import preprocess_3dgs as t_pre3
from gaus_slam_tpu_torch.ops.preprocess_3dgs import scales_to_3d as t_s3d


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


H, W, CAP = 32, 32, 2048
FIELDS = ("xyz", "log_scales", "quats", "opacity_logit", "rgb")
PRE_FIELDS = ("t_w", "a0", "a1", "a2", "center", "radius", "depth",
              "opacity")


def _w2c(seed):
    """A rigid w2c: a small rotation about a random axis and a shift."""
    rng = np.random.default_rng(seed)
    ax = rng.normal(size=3)
    ax /= np.linalg.norm(ax)
    ang = 0.2
    k = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                  [-ax[1], ax[0], 0]])
    m = np.eye(4)
    m[:3, :3] = np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * k @ k
    m[:3, 3] = rng.uniform(-0.1, 0.1, 3)
    return m.astype(np.float32)


def _points(seed, n=48, w2c=None):
    """Random gaussians in front of the camera ``w2c`` (identity when
    None), the first three behind it or inside its near plane."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    rng.uniform(1.5, 4.0, n)], -1)
    xyz[:3, 2] = [-0.5, 0.1, 0.19]
    if w2c is not None:
        c2w = np.linalg.inv(w2c.astype(np.float64))
        xyz = xyz @ c2w[:3, :3].T + c2w[:3, 3]
    xyz = xyz.astype(np.float32)
    scales2 = rng.uniform(0.01, 0.08, (n, 2)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    op = rng.uniform(0.3, 0.9, n).astype(np.float32)
    active = rng.uniform(size=n) > 0.2
    return xyz, scales2, q, op, active


def _rel_close(t, j, tol, what):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    scale = max(float(np.abs(j).max()), 1e-6)
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("iso", [False, True])
def test_preprocess_3dgs_matches_jax(iso):
    w2c = _w2c(1)
    xyz, scales2, q, op, active = _points(0, w2c=w2c)
    jc = JCamera(48, 64, 80.0, 70.0, 32.0, 24.0, jnp.asarray(w2c))
    tc = TCamera(48, 64, 80.0, 70.0, 32.0, 24.0, torch.tensor(w2c))
    j = j_pre3(jnp.asarray(xyz), j_s3d(jnp.asarray(scales2), iso),
               jnp.asarray(q), jnp.asarray(op), jc, active=jnp.asarray(active))
    t = t_pre3(torch.tensor(xyz), t_s3d(torch.tensor(scales2), iso),
               torch.tensor(q), torch.tensor(op), tc,
               active=torch.tensor(active))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    assert not t.valid[:3].any()            # the near-plane cull
    v = np.asarray(j.valid)
    for f in PRE_FIELDS:
        _rel_close(getattr(t, f).numpy()[v], np.asarray(getattr(j, f))[v],
                   1e-6, f)
    for f in ("t_u", "t_v", "normal"):
        assert float(getattr(t, f).abs().max()) == 0.0, f
    assert not t.radius.requires_grad


def _numpy_ewa(xyz, scales3, quat, fx, fy, w, h):
    """Independent EWA cov2d and conic in numpy (tests/test_3dgs.py)."""
    R = np.asarray(j_rotmat(jnp.asarray(quat)[None]))[0]
    S = np.diag(scales3)
    sigma = (R @ S) @ (R @ S).T
    pv = xyz
    limx, limy = 1.3 * w / (2 * fx), 1.3 * h / (2 * fy)
    txz = np.clip(pv[0] / pv[2], -limx, limx)
    tyz = np.clip(pv[1] / pv[2], -limy, limy)
    J = np.array([[fx / pv[2], 0, -fx * txz / pv[2]],
                  [0, fy / pv[2], -fy * tyz / pv[2]]])
    cov = J @ sigma @ J.T + 0.3 * np.eye(2)
    return np.linalg.inv(cov)


@pytest.mark.parametrize("iso", [False, True])
def test_preprocess_3dgs_is_the_ewa_conic(iso):
    """The pixel-linear map's density at probe pixels is the numpy EWA
    conic's quadratic form; depth is the view z; every conic eigenvalue
    stays under 1 / 0.3 (the low-pass branch is never taken)."""
    xyz, scales2, q, op, _ = _points(2)
    xyz = xyz[3:]
    scales2, q, op = scales2[3:], q[3:], op[3:]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s3 = t_s3d(torch.tensor(scales2), iso)
    cam = TCamera(64, 64, 80.0, 70.0, 32.0, 30.0, torch.eye(4))
    pre = t_pre3(torch.tensor(xyz), s3, torch.tensor(q), torch.tensor(op),
                 cam)
    a0, a1, a2 = pre.a0.numpy(), pre.a1.numpy(), pre.a2.numpy()
    ctr, depth = pre.center.numpy(), pre.depth.numpy()
    for i in range(xyz.shape[0]):
        conic = _numpy_ewa(xyz[i].astype(np.float64),
                           s3[i].numpy().astype(np.float64), q[i],
                           80.0, 70.0, 64, 64)
        for dx, dy in [(0.5, -1.0), (2.0, 1.5), (-1.0, 0.0)]:
            px, py = ctr[i, 0] + dx, ctr[i, 1] + dy
            sx = px * a0[i, 0] + py * a1[i, 0] + a2[i, 0]
            sy = px * a0[i, 1] + py * a1[i, 1] + a2[i, 1]
            sz = px * a0[i, 2] + py * a1[i, 2] + a2[i, 2]
            assert sz == 1.0
            d = np.array([dx, dy])
            np.testing.assert_allclose(sx * sx + sy * sy, d @ conic @ d,
                                       rtol=2e-3, atol=1e-4)
        np.testing.assert_allclose(depth[i], xyz[i, 2], rtol=1e-6)
        assert np.linalg.eigvalsh(conic).max() < 1.0 / 0.3 + 1e-6


def _jittered_maps(seed=0):
    """Frame 0 of the synthetic scene at 32x32, with numpy-seeded scale
    and rotation jitter (anisotropic gaussians), in both packages."""
    ds = SyntheticDataset(height=H, width=W, num_frames=60)
    color, depth, K, c2w0 = ds[0]
    jc = j_cam(H, W, K, np.eye(4))
    jgm = j_init_map(CAP, jnp.asarray(color / 255.0), jnp.asarray(depth),
                     jnp.eye(4), jc)
    rng = np.random.default_rng(seed)
    act = np.asarray(jgm.active)[:, None]
    p = jgm.params
    jgm = jgm._replace(params=p._replace(
        log_scales=p.log_scales + act * rng.normal(
            0, 0.3, (CAP, 2)).astype(np.float32),
        quats=p.quats + act * rng.normal(0, 0.2, (CAP, 4)).astype(np.float32),
        opacity_logit=jnp.where(act, rng.normal(
            0, 1.5, (CAP, 1)).astype(np.float32), p.opacity_logit)))
    tgm = convert.gaussian_map_from_numpy(
        {"params": jgm.params._asdict(), "m": jgm.m._asdict(),
         "v": jgm.v._asdict(), "step": jgm.step, "active": jgm.active,
         "n_active": jgm.n_active}, device="cpu")
    tc = t_cam(H, W, K, np.eye(4), device="cpu")
    w2c = (np.linalg.inv(ds[2][3]) @ c2w0).astype(np.float32)
    return jgm, tgm, jc, tc, w2c


def _opts(jc, tc, iso):
    kw = dict(pair_budget_factor=4, max_tiles_per_gaussian=4,
              method="3dgs", iso3d=iso)
    return (JR.RenderOptions(grid=JB.make_grid(jc, 16, 16),
                             backend="interpret", **kw),
            TR.RenderOptions(grid=TB.make_grid(tc, 16, 16), **kw))


@pytest.fixture(scope="module")
def maps():
    return _jittered_maps()


def close_out(t, j, tol=1e-4):
    t, j = np.asarray(t), np.asarray(j)
    for c in range(16):
        scale = max(float(np.abs(j[:, c]).max()), 1e-3)
        np.testing.assert_allclose(t[:, c], j[:, c], rtol=0, atol=tol * scale,
                                   err_msg=f"channel {c}")


def close_grad(t, j, tol=1e-3):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    err = np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-30)
    assert err <= tol, err


@pytest.mark.parametrize("iso", [False, True])
def test_render_view_and_full_3dgs_match_jax(maps, iso):
    """render_view, and render_full's parameter gradients through the
    pair expansion's reduction; middepth and distortion are zero, and
    surface-aware fusion is off although use_sa is set."""
    jgm, tgm, jc, tc, w2c = maps
    jo, to = _opts(jc, tc, iso)
    assert jo.use_sa and to.use_sa and not to.settings().use_sa
    jcam = jc.replace_w2c(jnp.asarray(w2c))
    tcam = tc.replace_w2c(torch.tensor(w2c))
    jv = np.asarray(JR.render_view(jgm, jcam, jo))
    tv = TR.render_view(tgm, tcam, to).numpy()
    close_out(tv, jv)
    assert np.abs(tv[:, 8:10]).max() == 0.0 and np.abs(tv[:, 5:8]).max() == 0.0
    assert tv[:, 4].max() > 0.5

    rng = np.random.default_rng(3)
    dw = rng.normal(size=tv.shape).astype(np.float32)
    dw[:, 10:] = 0.0
    jbins = JR.bin_full(jgm.params, jgm.active, jcam, jo)
    tbins = TR.bin_full(tgm.params, tgm.active, tcam, to)
    np.testing.assert_array_equal(tbins.tile_start.numpy(),
                                  np.asarray(jbins.tile_start))
    np.testing.assert_array_equal(tbins.tile_stop.numpy(),
                                  np.asarray(jbins.tile_stop))

    def jloss(params):
        out, _ = JR.render_full(params, jgm.active, jcam, jo, bins=jbins,
                                need_normal=False)
        return jnp.sum(out * dw), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jgm.params)
    params = type(tgm.params)(*(p.clone().requires_grad_()
                                for p in tgm.params))
    tout, _ = TR.render_full(params, tgm.active, tcam, to, bins=tbins,
                             need_normal=False)
    tg = torch.autograd.grad(torch.sum(tout * torch.tensor(dw)), list(params))
    close_out(tout.detach().numpy(), jout)
    g_xyz = float(tg[0].norm())
    for f, g in zip(FIELDS, tg):
        if iso and f == "quats":
            # an isotropic covariance does not depend on the rotation: both
            # gradients are rounding noise
            assert float(g.norm()) < 1e-5 * g_xyz
            assert float(np.linalg.norm(jg.quats)) < 1e-5 * g_xyz
            continue
        close_grad(g.numpy(), getattr(jg, f))
        assert float(g.abs().max()) > 0, f


@pytest.mark.parametrize("pre", [False, True])
def test_render_tracking_3dgs_and_pose_grad_match_jax(maps, pre):
    """The tracking cache's 3DGS render and its pose gradient, alone and
    composed right of a fixed ``pre_w2c`` (backend tracking)."""
    jgm, tgm, jc, tc, w2c = maps
    jo, to = _opts(jc, tc, iso=False)
    pre_w2c = _w2c(4) if pre else None
    pose_w2c = w2c if not pre else np.linalg.inv(pre_w2c) @ w2c
    jp = j_init_pose(jnp.asarray(pose_w2c, jnp.float32))
    eff = np.asarray(jp.w2c) if not pre else pre_w2c @ np.asarray(jp.w2c)
    jcache = JR.bin_for_tracking(jgm, jc.replace_w2c(jnp.asarray(eff)), jo)
    tcache = TR.bin_for_tracking(tgm, tc.replace_w2c(torch.tensor(eff)), to)
    for f in ("tile_start", "tile_stop", "num_pairs", "overflow"):
        np.testing.assert_array_equal(getattr(tcache, f).numpy(),
                                      np.asarray(getattr(jcache, f)), f)
    q, t = np.asarray(jp.quat), np.asarray(jp.trans)
    rng = np.random.default_rng(5)
    dw = rng.normal(size=(jo.grid.num_tiles, 16, 256)).astype(np.float32)
    dw[:, 10:] = 0.0
    jpre = None if pre_w2c is None else jnp.asarray(pre_w2c)
    tpre = None if pre_w2c is None else torch.tensor(pre_w2c)

    def jloss(qq, tt):
        out = JR.render_tracking(jcache, qq, tt, jc, jo, pre_w2c=jpre)
        return jnp.sum(out * dw), out

    (_, jout), (jgq, jgt) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(q), jnp.asarray(t))
    tq = torch.tensor(q, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    tout = TR.render_tracking(tcache, tq, tt, tc, to, pre_w2c=tpre)
    tgq, tgt = torch.autograd.grad(torch.sum(tout * torch.tensor(dw)),
                                   (tq, tt))
    close_out(tout.detach().numpy(), jout)
    close_grad(tgq.numpy(), jgq)
    close_grad(tgt.numpy(), jgt)
    assert float(tgt.abs().max()) > 0


def _faceon_params(lib, xyz, s, rgb, op_logit):
    n = xyz.shape[0]
    ls = np.log(np.stack([s, s], -1)).astype(np.float32)
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))
    if lib == "jax":
        return JG.Params(xyz=jnp.asarray(xyz), log_scales=jnp.asarray(ls),
                         quats=jnp.asarray(quats),
                         opacity_logit=jnp.asarray(op_logit),
                         rgb=jnp.asarray(rgb))
    return TG.Params(xyz=torch.tensor(xyz), log_scales=torch.tensor(ls),
                     quats=torch.tensor(quats),
                     opacity_logit=torch.tensor(op_logit),
                     rgb=torch.tensor(rgb))


def test_3dgs_matches_2dgs_faceon():
    """tests/test_3dgs.py:88 in the port: face-on gaussians give nearly
    the 2DGS surfels' image (the +0.3 px EWA dilation compensated in the
    3DGS scales), depth the plane depth, zero normal / middepth / dist;
    and the port's 3DGS render equals the JAX package's."""
    rng = np.random.default_rng(1)
    n, f = 24, 40.0
    z = rng.uniform(1.5, 3.0, n)
    xyz = np.stack([(rng.uniform(6, 26, n) - 16) * z / f,
                    (rng.uniform(6, 26, n) - 16) * z / f, z],
                   -1).astype(np.float32)
    sig_pix = rng.uniform(2.0, 4.0, n)
    s2d = sig_pix * z / f
    s3d = np.sqrt(np.maximum(sig_pix ** 2 - 0.3, 1e-3)) * z / f
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    op_logit = np.full((n, 1), 1.2, np.float32)

    outs = {}
    for method, s in (("2dgs", s2d), ("3dgs", s3d)):
        cam = TCamera(32, 32, f, f, 16.0, 16.0, torch.eye(4))
        opts = TR.RenderOptions(grid=TB.make_grid(cam, 16, 16), use_sa=False,
                                pair_budget_factor=8, method=method)
        out, _ = TR.render_full(_faceon_params("torch", xyz, s, rgb,
                                               op_logit),
                                torch.ones(n, dtype=torch.bool), cam, opts)
        outs[method] = out.numpy()
    a, b = outs["2dgs"], outs["3dgs"]
    np.testing.assert_allclose(a[:, 4], b[:, 4], atol=0.035)
    np.testing.assert_allclose(a[:, 0:3], b[:, 0:3], atol=0.035)
    m = (a[:, 4] > 0.5) & (b[:, 4] > 0.5)
    da = a[:, 3] / np.maximum(a[:, 4], 1e-6)
    db = b[:, 3] / np.maximum(b[:, 4], 1e-6)
    assert m.sum() > 50
    np.testing.assert_allclose(da[m], db[m], rtol=0.02)
    assert np.abs(b[:, 8:10]).max() == 0.0
    assert np.abs(b[:, 5:8]).max() == 0.0

    jcam = JCamera(32, 32, f, f, 16.0, 16.0, jnp.eye(4))
    jo = JR.RenderOptions(grid=JB.make_grid(jcam, 16, 16),
                          backend="interpret", use_sa=False,
                          pair_budget_factor=8, method="3dgs")
    jout, _ = JR.render_full(_faceon_params("jax", xyz, s3d, rgb, op_logit),
                             jnp.ones((n,), bool), jcam, jo)
    close_out(b, np.asarray(jout))


def test_mean_knn_sq_dist_matches_jax():
    rng = np.random.default_rng(6)
    pts = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    pts[100:110] = pts[100]                   # duplicates: zero distances
    for k, window in ((3, 8), (1, 2)):
        j = np.asarray(JK.mean_knn_sq_dist(jnp.asarray(pts), k=k,
                                           window=window))
        t = TK.mean_knn_sq_dist(torch.tensor(pts), k=k, window=window).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
        assert t.min() >= 1e-7


def test_sh_matches_jax():
    rgb = np.random.default_rng(7).uniform(0, 1, (64, 3)).astype(np.float32)
    t_sh = TS.rgb_to_sh(torch.tensor(rgb))
    np.testing.assert_array_equal(t_sh.numpy(),
                                  np.asarray(JS.rgb_to_sh(jnp.asarray(rgb))))
    np.testing.assert_array_equal(
        TS.sh_to_rgb(t_sh).numpy(),
        np.asarray(JS.sh_to_rgb(jnp.asarray(t_sh.numpy()))))
    np.testing.assert_allclose(TS.sh_to_rgb(t_sh).numpy(), rgb, atol=1e-6)
