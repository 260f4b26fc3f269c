"""Map initialization from an RGB-D frame (port of
gaus_slam_tpu/slam/init_map.py; reference Frontend.create_map)."""
from __future__ import annotations

import torch

from ..models import gaussians as G
from ..ops.camera import Camera
from ..ops.geometry import (depth_scale_init, normals_from_points,
                            points_from_depth, valid_depth_mask)
from ..ops.se3 import invert_se3, transform_points


@torch.no_grad()
def initialize_map(capacity: int, gt_color: torch.Tensor,
                   gt_depth: torch.Tensor, w2c: torch.Tensor,
                   cam_proj: Camera) -> G.GaussianMap:
    """Unproject every valid pixel of the frame into a surfel; the map
    lives on ``gt_depth``'s device."""
    cam = cam_proj.replace_w2c(w2c)
    pts_cam = points_from_depth(gt_depth, cam)
    c2w = invert_se3(w2c)
    pts_w = transform_points(c2w, pts_cam.reshape(-1, 3)).reshape(pts_cam.shape)
    normals = normals_from_points(pts_w)
    valid = valid_depth_mask(gt_depth)
    scale = depth_scale_init(gt_depth, cam)
    return G.create_from_points_masked(
        capacity,
        pts_w.reshape(-1, 3),
        gt_color.reshape(-1, 3),
        normals.reshape(-1, 3),
        scale.reshape(-1),
        valid.reshape(-1),
    )
