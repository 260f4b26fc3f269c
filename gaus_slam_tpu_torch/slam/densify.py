"""Map densification and pruning (port of gaus_slam_tpu/slam/densify.py;
reference slam/Densify.py).

SplaTAM-style growth: every pixel is a candidate; pixels where the
current map renders insufficient alpha or grossly wrong depth are
unprojected from the ground-truth RGB-D and appended.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import gaussians as G
from ..ops.camera import Camera
from ..ops.composite_ref import tiles_to_image
from ..ops.geometry import (depth_scale_init, normals_from_points,
                            points_from_depth, valid_depth_mask)
from ..ops.se3 import invert_se3, transform_points
from ..render import RenderOptions
from .loss import LossConfig, normalized_depth


class DensifyConfig(NamedTuple):
    sil_thres: float = 0.6
    dep_thres: float = 0.1
    opacity_cull: float = 0.05
    scale_cull: float = 5e-4
    scale_max: float = 0.1
    use_edge_growth: bool = False
    edge_thres: float = 0.4


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over all elements, averaging the two middle values of an
    even count (jnp.median semantics; torch.median takes the lower)."""
    v = torch.sort(x.reshape(-1)).values
    n = v.shape[0]
    if n % 2:
        return v[n // 2]
    return (v[n // 2 - 1] + v[n // 2]) / 2


@torch.no_grad()
def add_new_gaussians(gm: G.GaussianMap, w2c: torch.Tensor,
                      gt_color: torch.Tensor, gt_depth: torch.Tensor,
                      out_view: torch.Tensor, cam_proj: Camera,
                      opts: RenderOptions, dcfg: DensifyConfig,
                      lcfg: LossConfig) -> G.GaussianMap:
    """Densify.add_new_gaussians, splatam method; ``out_view`` is the
    detached render [T, OUT_C, P] at ``w2c``."""
    h, w = cam_proj.height, cam_proj.width
    img = tiles_to_image(
        torch.stack([normalized_depth(out_view, lcfg), out_view[:, 4]], dim=1),
        opts.grid, h, w,
    )
    depth = img[0]
    alpha = img[1]

    sil_mask = alpha < dcfg.sil_thres
    depth_error = torch.where(gt_depth > 0, torch.abs(depth - gt_depth),
                              torch.zeros_like(depth))
    med = _median(depth_error)
    add_mask = sil_mask | ((depth > gt_depth) & (depth_error > 50.0 * med))
    valid = valid_depth_mask(gt_depth) & add_mask

    cam = cam_proj.replace_w2c(w2c)
    c2w = invert_se3(w2c)

    def unproject_add(gm, src_depth, valid):
        pts_cam = points_from_depth(src_depth, cam)
        pts_w = transform_points(c2w, pts_cam.reshape(-1, 3)) \
            .reshape(pts_cam.shape)
        normals = normals_from_points(pts_w)
        scale = depth_scale_init(src_depth, cam)
        return G.add_gaussians(
            gm, pts_w.reshape(-1, 3), gt_color.reshape(-1, 3),
            normals.reshape(-1, 3), scale.reshape(-1),
            valid=valid.reshape(-1),
        )

    gm = unproject_add(gm, gt_depth, valid)
    if dcfg.use_edge_growth:
        edge_mask = (
            (alpha > dcfg.edge_thres) & (alpha < dcfg.sil_thres)
            & (gt_depth < 1e-3) & (depth > 1e-3)
        )
        gm = unproject_add(gm, depth, edge_mask)
    return gm


@torch.no_grad()
def prune_gaussians(gm: G.GaussianMap, dcfg: DensifyConfig) -> G.GaussianMap:
    """Densify.prune_gaussians: hard prune by opacity and mean-scale."""
    opac = torch.sigmoid(gm.params.opacity_logit[:, 0])
    mean_scale = torch.exp(gm.params.log_scales).mean(dim=-1)
    mask = (
        (opac < dcfg.opacity_cull)
        | (mean_scale < dcfg.scale_cull)
        | (mean_scale > dcfg.scale_max)
    )
    return G.prune(gm, mask & gm.active)
