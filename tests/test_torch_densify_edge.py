"""Port parity of edge-growth densification (slam/densify.py's
``use_edge_growth`` branch, reference slam/Densify.py:29-39) and of the
mapping loss's edge colour mask (slam/loss.py, ``use_edge_growth``)
against the JAX package, on tests/test_densify_edge.py's scene: a
sensor-dropout band rendered at partial alpha.

The same gaussians are added (count exactly, rows to 1e-6 of each
field's scale); the loss terms agree to 1e-6 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaus_slam_tpu.models import gaussians as JG
from gaus_slam_tpu.ops.binning import make_grid as j_grid
from gaus_slam_tpu.ops.camera import Camera as JCamera
from gaus_slam_tpu.ops.composite_ref import image_to_tiles as j_tiles
from gaus_slam_tpu.ops.compositing import OUT_C
from gaus_slam_tpu.render import RenderOptions as JOpts
from gaus_slam_tpu.slam import densify as JD
from gaus_slam_tpu.slam import loss as JL
from gaus_slam_tpu_torch.models import gaussians as TG
from gaus_slam_tpu_torch.ops.binning import make_grid as t_grid
from gaus_slam_tpu_torch.ops.camera import Camera as TCamera
from gaus_slam_tpu_torch.ops.composite_ref import image_to_tiles as t_tiles
from gaus_slam_tpu_torch.render import RenderOptions as TOpts
from gaus_slam_tpu_torch.slam import densify as TD
from gaus_slam_tpu_torch.slam import loss as TL

H = W = 32
BAND = slice(12, 18)


def _scene():
    """(gt color, gt depth with a dropout band, [OUT_C, H, W] render
    whose band has alpha 0.5) in numpy."""
    rng = np.random.default_rng(0)
    gt_color = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    gt_depth = np.full((H, W), 2.0, np.float32)
    gt_depth[:, BAND] = 0.0
    alpha = np.full((H, W), 0.95, np.float32)
    alpha[:, BAND] = 0.5
    img = np.zeros((OUT_C, H, W), np.float32)
    img[3] = alpha * 2.0
    img[4] = alpha
    return gt_color, gt_depth, img


@pytest.mark.parametrize("edge,edge_thres,n_expect", [
    (False, 0.4, 0), (True, 0.4, H * 6), (True, 0.55, 0)])
def test_add_new_gaussians_edge_growth_matches_jax(edge, edge_thres, n_expect):
    gt_color, gt_depth, img = _scene()
    jcam = JCamera(H, W, 40.0, 40.0, 16.0, 16.0, jnp.eye(4))
    tcam = TCamera(H, W, 40.0, 40.0, 16.0, 16.0, torch.eye(4))
    jopts = JOpts(grid=j_grid(jcam, 16, 16), backend="interpret")
    topts = TOpts(grid=t_grid(tcam, 16, 16))
    kw = dict(sil_thres=0.6, edge_thres=edge_thres, use_edge_growth=edge)
    jgm = JD.add_new_gaussians(
        JG.empty_map(4096), jnp.eye(4), jnp.asarray(gt_color),
        jnp.asarray(gt_depth), j_tiles(jnp.asarray(img), jopts.grid), jcam,
        jopts, JD.DensifyConfig(**kw), JL.LossConfig())
    tgm = TD.add_new_gaussians(
        TG.empty_map(4096, device="cpu"), torch.eye(4),
        torch.tensor(gt_color), torch.tensor(gt_depth),
        t_tiles(torch.tensor(img), topts.grid), tcam, topts,
        TD.DensifyConfig(**kw), TL.LossConfig())
    n = int(jgm.n_active)
    assert n == n_expect
    assert int(tgm.n_active) == n
    np.testing.assert_array_equal(tgm.active.numpy(), np.asarray(jgm.active))
    for f, t, j in zip(TG.PARAM_FIELDS, tgm.params, jgm.params):
        j = np.asarray(j)[:n]
        scale = max(float(np.abs(j).max()), 1e-6) if n else 1.0
        np.testing.assert_allclose(t.numpy()[:n], j, rtol=0,
                                   atol=1e-6 * scale, err_msg=f)
    if n:
        # grown at the rendered depth, on the band's columns
        xyz = tgm.params.xyz[:n].numpy()
        np.testing.assert_allclose(xyz[:, 2], 2.0, rtol=1e-5)
        u = xyz[:, 0] * 40.0 / 2.0 + 16.0
        assert u.min() > 11.0 and u.max() < 18.5


@pytest.mark.parametrize("edge", [False, True])
def test_mapping_loss_edge_mask_matches_jax(edge):
    """With use_edge_growth the colour mask is alpha > edge_thres rather
    than the depth mask, so the band's pixels carry colour loss."""
    gt_color, gt_depth, img = _scene()
    rng = np.random.default_rng(1)
    img[0:3] = rng.uniform(0, 1, (3, H, W))
    img[9] = rng.uniform(0, 0.1, (H, W))
    gt = np.concatenate([gt_color.transpose(2, 0, 1), gt_depth[None]], 0)
    grid = t_grid(TCamera(H, W, 40.0, 40.0, 16.0, 16.0, torch.eye(4)),
                  16, 16)
    jgrid = j_grid(JCamera(H, W, 40.0, 40.0, 16.0, 16.0, jnp.eye(4)), 16, 16)
    kw = dict(use_edge_growth=edge, edge_thres=0.4, w_dist=0.1)
    jl, jaux = JL.mapping_loss(j_tiles(jnp.asarray(img), jgrid),
                               j_tiles(jnp.asarray(gt), jgrid),
                               JL.LossConfig(**kw))
    tl, taux = TL.mapping_loss(t_tiles(torch.tensor(img), grid),
                               t_tiles(torch.tensor(gt), grid),
                               TL.LossConfig(**kw))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for k in ("l_color", "l_depth", "l_dist"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-6,
                                   err_msg=k)
    # the edge mask admits the band: its colour loss differs from the
    # depth-masked one
    other = TL.mapping_loss(t_tiles(torch.tensor(img), grid),
                            t_tiles(torch.tensor(gt), grid),
                            TL.LossConfig(**dict(kw, use_edge_growth=not edge)))
    assert float(other[1]["l_color"]) != float(taux["l_color"])
