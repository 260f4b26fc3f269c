"""Port parity of the render facade (render/__init__.py) against the JAX
package on the same map (frame 0 of the synthetic scene at 48x64, carried
over with convert.py): the tracking pair cache, the tracking render and
its pose gradient (means through the live pose, rotated quaternions
detached), and the mapping render's parameter gradients through the
pair expansion's reduction — dense and the compact per-phase path.

Tolerances: renders 1e-4 of each channel's scale and gradients 1e-3
relative L2 per parameter field, as in test_torch_raster (float32 sums
in another order through the compositor); tile ranges and binning
diagnostics exactly, the cached raw parameters to an ulp (exp and
sigmoid of the two libraries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaus_slam_tpu import render as JR
from gaus_slam_tpu.data.synthetic import SyntheticDataset
from gaus_slam_tpu.models.frame import init_pose as j_init_pose
from gaus_slam_tpu.ops import binning as JB
from gaus_slam_tpu.ops.camera import camera_from_intrinsics as j_cam
from gaus_slam_tpu.slam.init_map import initialize_map as j_init_map
from gaus_slam_tpu_torch import convert
from gaus_slam_tpu_torch import render as TR
from gaus_slam_tpu_torch.ops import binning as TB
from gaus_slam_tpu_torch.ops.camera import camera_from_intrinsics as t_cam
from gaus_slam_tpu_torch.slam.steps import _coarse_map_phases


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


H, W, CAP = 48, 64, 4096
FIELDS = ("xyz", "log_scales", "quats", "opacity_logit", "rgb")


@pytest.fixture(scope="module")
def setup():
    ds = SyntheticDataset(height=H, width=W, num_frames=60)
    color, depth, K, c2w0 = ds[0]
    jc = j_cam(H, W, K, np.eye(4))
    jgm = j_init_map(CAP, jnp.asarray(color / 255.0), jnp.asarray(depth),
                     jnp.eye(4), jc)
    tgm = convert.gaussian_map_from_numpy(
        {"params": jgm.params._asdict(), "m": jgm.m._asdict(),
         "v": jgm.v._asdict(), "step": jgm.step, "active": jgm.active,
         "n_active": jgm.n_active}, device="cpu")
    tc = t_cam(H, W, K, np.eye(4), device="cpu")
    jo = JR.RenderOptions(grid=JB.make_grid(jc, 16, 16), backend="interpret",
                          pair_budget_factor=1.35, max_tiles_per_gaussian=4)
    to = TR.RenderOptions(grid=TB.make_grid(tc, 16, 16),
                          pair_budget_factor=1.35, max_tiles_per_gaussian=4)
    # the pose of frame 2 relative to frame 0, and a random cotangent
    w2c = (np.linalg.inv(ds[2][3]) @ c2w0).astype(np.float32)
    rng = np.random.default_rng(0)
    return jgm, tgm, jc, tc, jo, to, w2c, rng


def close_out(t, j, tol=1e-4):
    """Each channel within tol of its scale; SA's distortion channel
    (D2 - 2*mm*D + mm^2*(1-T), a cancellation) within tol of its terms'."""
    t, j = np.asarray(t), np.asarray(j)
    terms = np.abs(j[:, 8] * j[:, 3]) + j[:, 8] ** 2
    for c in range(13):
        ref = terms if c == 9 else np.abs(j[:, c])
        scale = max(float(ref.max()), 1e-3)
        np.testing.assert_allclose(t[:, c], j[:, c], rtol=0, atol=tol * scale,
                                   err_msg=f"channel {c}")


def close_grad(t, j, tol=1e-3):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    err = np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-30)
    assert err <= tol, err


def test_tracking_cache_render_and_pose_grad_match_jax(setup):
    jgm, tgm, jc, tc, jo, to, w2c, rng = setup
    jp = j_init_pose(jnp.asarray(w2c))
    jcache = JR.bin_for_tracking(jgm, jc.replace_w2c(jp.w2c), jo,
                                 coarse_strides=(3,))
    q, t = np.asarray(jp.quat), np.asarray(jp.trans)
    tcache = TR.bin_for_tracking(tgm, tc.replace_w2c(torch.tensor(
        np.asarray(jp.w2c))), to, coarse_strides=(3,))
    for f in ("tile_start", "tile_stop", "num_pairs", "overflow", "n_shrunk",
              "demand"):
        np.testing.assert_array_equal(getattr(tcache, f).numpy(),
                                      np.asarray(getattr(jcache, f)), f)
    # gathered raw parameters: exp / sigmoid round to an ulp apart
    np.testing.assert_allclose(tcache.raw_t.numpy(), np.asarray(jcache.raw_t),
                               rtol=1e-6, atol=1e-7)

    ids = np.asarray(
        jnp.arange(0, jo.grid.tiles_y, 3)[:, None] * jo.grid.tiles_x
        + jnp.arange(0, jo.grid.tiles_x, 3)[None, :]).reshape(-1)
    hi = JR.track_coarse_budget(jcache.raw_t.shape[1], 3)
    assert hi == TR.track_coarse_budget(tcache.raw_t.shape[1], 3)
    for tile_ids, pair_hi in ((None, None), (ids.astype(np.int32), hi)):
        n = jo.grid.num_tiles if tile_ids is None else len(tile_ids)
        dw = rng.normal(size=(n, 16, 256)).astype(np.float32)
        dw[:, 10:] = 0.0
        jids = None if tile_ids is None else jnp.asarray(tile_ids)
        tids = None if tile_ids is None else torch.tensor(tile_ids)

        def jloss(qq, tt):
            out = JR.render_tracking(jcache, qq, tt, jc, jo, tile_ids=jids,
                                     pair_hi=pair_hi)
            return jnp.sum(out * dw), out

        (_, jout), (jgq, jgt) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(q), jnp.asarray(t))
        tq = torch.tensor(q, requires_grad=True)
        tt = torch.tensor(t, requires_grad=True)
        tout = TR.render_tracking(tcache, tq, tt, tc, to, tile_ids=tids,
                                  pair_hi=pair_hi)
        tgq, tgt = torch.autograd.grad(torch.sum(tout * torch.tensor(dw)),
                                       (tq, tt))
        close_out(tout.detach().numpy(), jout)
        close_grad(tgq.numpy(), jgq)
        close_grad(tgt.numpy(), jgt)


@pytest.mark.parametrize("phase", [None, 4])
def test_mapping_render_and_param_grads_match_jax(setup, phase):
    """Dense mapping render (expand_pairs) and one compact coarse phase
    (expand_pairs_phase), gradients through the pair->gaussian
    reduction."""
    jgm, tgm, jc, tc, jo, to, w2c, rng = setup
    stride = 3 if phase is not None else 0
    jcam = jc.replace_w2c(jnp.asarray(w2c))
    tcam = tc.replace_w2c(torch.tensor(w2c))
    jbins = JR.bin_full(jgm.params, jgm.active, jcam, jo, phase_stride=stride)
    tbins = TR.bin_full(tgm.params, tgm.active, tcam, to, phase_stride=stride)
    kw_j, kw_t = {}, {}
    n_tiles = jo.grid.num_tiles
    if phase is not None:
        ph, pv = _coarse_map_phases(to.grid, 3, "cpu")
        ids, valid = ph[phase].numpy(), pv[phase].numpy()
        kw_j = dict(tile_ids=jnp.asarray(ids), tile_valid=jnp.asarray(valid),
                    phase=phase, coarse_stride=3)
        kw_t = dict(tile_ids=torch.tensor(ids), tile_valid=torch.tensor(valid),
                    phase=phase, coarse_stride=3)
        n_tiles = len(ids)
    dw = rng.normal(size=(n_tiles, 16, 256)).astype(np.float32)
    dw[:, 10:] = 0.0

    def jloss(params):
        out, _ = JR.render_full(params, jgm.active, jcam, jo, bins=jbins,
                                need_normal=False, **kw_j)
        return jnp.sum(out * dw), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jgm.params)
    params = type(tgm.params)(*(p.clone().requires_grad_()
                                for p in tgm.params))
    tout, _ = TR.render_full(params, tgm.active, tcam, to, bins=tbins,
                             need_normal=False, **kw_t)
    tg = torch.autograd.grad(torch.sum(tout * torch.tensor(dw)), list(params))
    close_out(tout.detach().numpy(), jout)
    for f, g in zip(FIELDS, tg):
        close_grad(g.numpy(), getattr(jg, f))
    assert float(tg[0].abs().max()) > 0
