"""Map initialization from an RGB-D frame (port of
gaus_slam_tpu/slam/init_map.py; reference Frontend.create_map)."""
from __future__ import annotations

import torch

from ..models import gaussians as G
from ..ops.camera import Camera
from ..ops.geometry import (depth_scale_init, normals_from_points,
                            points_from_depth, valid_depth_mask)
from ..ops.se3 import invert_se3, transform_points
from . import programs


def initialize_map(capacity: int, gt_color: torch.Tensor,
                   gt_depth: torch.Tensor, w2c: torch.Tensor,
                   cam_proj: Camera, owner=None) -> G.GaussianMap:
    """Unproject every valid pixel of the frame into a surfel; the map
    lives on ``gt_depth``'s device. One captured program of ``owner``
    (slam/programs.py; the default owner when None) keyed by
    ``capacity``, as the JAX package jits it with the capacity static;
    the map lands in the buffers of the argument ``gm`` of the owner's
    other programs, where its first mapping step reads it."""
    return programs.call(
        owner, "initialize_map", _initialize_map,
        dict(gt_color=gt_color, gt_depth=gt_depth, w2c=w2c,
             cam_proj=cam_proj),
        dict(capacity=capacity), outs=".gm", capacity=capacity)


@torch.no_grad()
def _initialize_map(gt_color, gt_depth, w2c, cam_proj, *, capacity):
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
