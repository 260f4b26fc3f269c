"""Depth-image geometry: unprojection, normals, gaussian initialization
(port of gaus_slam_tpu/ops/geometry.py)."""
from __future__ import annotations

import torch

from .camera import Camera
from .se3 import rotmat_to_quat


def pixel_grid(h: int, w: int, device):
    x = torch.arange(w, dtype=torch.float32, device=device)[None, :].repeat(h, 1)
    y = torch.arange(h, dtype=torch.float32, device=device)[:, None].repeat(1, w)
    return x, y


def points_from_depth(depth: torch.Tensor, cam: Camera) -> torch.Tensor:
    """depth [H, W] -> camera-space points [H, W, 3]."""
    x, y = pixel_grid(cam.height, cam.width, depth.device)
    xx = (x - cam.cx) / cam.fx
    yy = (y - cam.cy) / cam.fy
    return torch.stack([xx * depth, yy * depth, depth], dim=-1)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def normals_from_points(pts: torch.Tensor) -> torch.Tensor:
    """Central-difference normals [H, W, 3]; zero on the one-pixel border."""
    dx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dy = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = _normalize(torch.linalg.cross(dx, dy, dim=-1))
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))


def valid_depth_mask(depth: torch.Tensor, near: float = 0.01,
                     far: float = 15.0) -> torch.Tensor:
    """Depth validity eroded by one pixel, replicating the reference's
    sequential in-place update order."""
    m = (depth > near) & (depth < far)
    nm = m.clone()
    nm[1:, :] = nm[1:, :] & m[:-1, :]
    nm[:, 1:] = nm[:, 1:] & m[:, :-1]
    nm[:-1, :] = nm[:-1, :] & nm[1:, :].clone()
    nm[:, :-1] = nm[:, :-1] & nm[:, 1:].clone()
    return nm


def depth_scale_init(depth: torch.Tensor, cam: Camera) -> torch.Tensor:
    """Initial gaussian scale per pixel: z / mean(fx, fy) [H, W]."""
    return depth / ((cam.fx + cam.fy) / 2.0)


def surfel_quat_from_normal(view_dir: torch.Tensor) -> torch.Tensor:
    """Quaternion orienting a surfel's z axis along ``view_dir`` [N, 3]
    (the reference's viewmatrix(lookdir, up) construction), identity
    where degenerate."""
    v2 = _normalize(view_dir)
    up = torch.stack(
        [
            view_dir[:, 1] * view_dir[:, 2],
            view_dir[:, 0] * view_dir[:, 2],
            -2.0 * view_dir[:, 0] * view_dir[:, 1],
        ],
        dim=-1,
    )
    v0 = torch.linalg.cross(up, v2, dim=-1)
    n0 = torch.linalg.norm(v0, dim=-1, keepdim=True)
    v0 = v0 / torch.clamp(n0, min=1e-12)
    v1 = _normalize(torch.linalg.cross(v2, v0, dim=-1))
    rot = torch.stack([v0, v1, v2], dim=-1)  # columns
    q = rotmat_to_quat(rot)
    bad = (
        (n0[:, 0] < 1e-9)
        | ~torch.isfinite(q).all(dim=-1)
        | (torch.linalg.norm(q, dim=-1) < 1e-3)
    )
    ident = torch.zeros_like(q)
    ident[:, 0] = 1.0
    return torch.where(bad[:, None], ident, q)
