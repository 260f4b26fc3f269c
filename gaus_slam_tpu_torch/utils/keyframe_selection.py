"""Projection-overlap keyframe selection (port of
gaus_slam_tpu/utils/keyframe_selection.py; reference
utils/keyframe_selection.py, which ships it but never calls it, nor does
either package). Samples pixels of the current depth map, back-projects
them and ranks candidate keyframes by the fraction that projects inside
their frustum.

``points_overlap`` scores given world points against the candidates;
``keyframe_overlap`` draws the points. Its draws come from an explicit
``torch.Generator`` and differ from the JAX package's ``jax.random``
ones; handed the same points, the two agree.
"""
from __future__ import annotations

import torch

from ..ops.camera import Camera
from ..ops.geometry import points_from_depth
from ..ops.se3 import invert_se3, transform_points


def points_overlap(pts_w: torch.Tensor, kf_w2cs: torch.Tensor, cam: Camera,
                   height: int, width: int) -> torch.Tensor:
    """[N, 3] world points, [K, 4, 4] keyframe poses -> [K] fraction of
    the points in front of each keyframe (z > 0.01) that project inside
    its height x width image."""
    p = transform_points(kf_w2cs, pts_w)                      # [K, N, 3]
    z = p[..., 2]
    zc = torch.clamp(z, min=1e-6)
    u = p[..., 0] / zc * cam.fx + cam.cx
    v = p[..., 1] / zc * cam.fy + cam.cy
    inside = (z > 0.01) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    return inside.to(torch.float32).mean(dim=-1)


def keyframe_overlap(gt_depth: torch.Tensor, w2c: torch.Tensor, cam: Camera,
                     kf_w2cs: torch.Tensor, pixels: int = 1600,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
    """-> overlap fraction [K] of current-frame geometry (``pixels`` valid
    pixels of ``gt_depth`` [H, W], drawn with replacement) visible in each
    candidate keyframe. ``generator`` lives on the depth's device; a
    fresh one seeded 0 by default."""
    h, w = gt_depth.shape
    if generator is None:
        generator = torch.Generator(device=gt_depth.device)
        generator.manual_seed(0)
    pts_cam = points_from_depth(gt_depth, cam).reshape(-1, 3)
    valid = (gt_depth > 0).reshape(-1).to(torch.float32)
    idx = torch.multinomial(valid / torch.clamp(valid.sum(), min=1), pixels,
                            replacement=True, generator=generator)
    pts_w = transform_points(invert_se3(w2c), pts_cam[idx])
    return points_overlap(pts_w, kf_w2cs, cam, h, w)
