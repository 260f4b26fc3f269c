"""Camera model and splat->pixel projection for the 2DGS rasterizer.

Port of gaus_slam_tpu/ops/camera.py. Conventions:

  * OpenGL-style projection with near=0.01, far=100 (projection only;
    the compositor separately clamps ray depth at NEAR_N=0.2).
  * pixel = ((ndc + 1) * S - 1) / 2  (the ``ndc2pix`` convention).
  * A 2D surfel with tangent frame L = R @ diag(su, sv) and center p maps
    splat-local homogeneous coords (u, v, 1) to pixel-homogeneous coords
    through a per-gaussian 3x3 matrix T with rows (Tu, Tv, Tw); the
    ray/splat intersection is linear in the pixel, p = x*A0 + y*A1 + A2.
"""
from __future__ import annotations

import numpy as np
import torch

from .consts import constant

# Compositing constants (the CUDA kernels in csrc/raster_common.cuh
# hold the same values, rounded to float32 the same way).
NEAR_N = 0.2
FAR_N = 100.0
FILTER_INV_SQUARE = 100.0
CUTOFF = 3.0
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4  # transmittance early-termination threshold


class Camera:
    """Intrinsics (plain python numbers) plus a ``w2c`` [4, 4] tensor,
    which may require grad (pose gradients flow through it)."""

    __slots__ = ("height", "width", "fx", "fy", "cx", "cy", "w2c",
                 "near", "far")

    def __init__(self, height, width, fx, fy, cx, cy, w2c,
                 near=0.01, far=100.0):
        self.height = int(height)
        self.width = int(width)
        self.fx = float(fx)
        self.fy = float(fy)
        self.cx = float(cx)
        self.cy = float(cy)
        self.w2c = w2c
        self.near = float(near)
        self.far = float(far)

    @property
    def intrinsics(self) -> np.ndarray:
        k = np.eye(4, dtype=np.float32)
        k[0, 0], k[1, 1], k[0, 2], k[1, 2] = self.fx, self.fy, self.cx, self.cy
        return k

    def replace_w2c(self, w2c) -> "Camera":
        return Camera(self.height, self.width, self.fx, self.fy, self.cx,
                      self.cy, w2c, self.near, self.far)


def camera_from_intrinsics(h, w, k, w2c, near=0.01, far=100.0,
                           device="cuda") -> Camera:
    k = np.asarray(k)
    return Camera(
        height=int(h), width=int(w),
        fx=float(k[0][0]), fy=float(k[1][1]),
        cx=float(k[0][2]), cy=float(k[1][2]),
        w2c=torch.as_tensor(np.asarray(w2c, np.float32), device=device),
        near=float(near), far=float(far),
    )


def opengl_projection(cam: Camera) -> torch.Tensor:
    """4x4 camera-space -> NDC-homogeneous projection (z forward positive).
    Its values depend on the intrinsics alone: made once per camera and
    device (ops/consts.py), never written by a caller."""
    w, h, near, far = cam.width, cam.height, cam.near, cam.far
    return constant(
        (
            (2 * cam.fx / w, 0.0, -(w - 2 * cam.cx) / w, 0.0),
            (0.0, 2 * cam.fy / h, -(h - 2 * cam.cy) / h, 0.0),
            (0.0, 0.0, far / (far - near), -(far * near) / (far - near)),
            (0.0, 0.0, 1.0, 0.0),
        ),
        torch.float32, cam.w2c.device,
    )


def world_to_pix3(cam: Camera) -> torch.Tensor:
    """Linear map [3, 4]: world homogeneous 4-vec -> pixel homogeneous
    3-vec (w2c, then the OpenGL projection, then ndc2pix, whose matrix is
    made once per image size and device)."""
    P = opengl_projection(cam) @ cam.w2c.float()
    w, h = cam.width, cam.height
    n2p = constant(
        (
            (w / 2.0, 0.0, 0.0, (w - 1) / 2.0),
            (0.0, h / 2.0, 0.0, (h - 1) / 2.0),
            (0.0, 0.0, 0.0, 1.0),
        ),
        torch.float32, cam.w2c.device,
    )
    return n2p @ P


def project_points(cam: Camera, pts: torch.Tensor):
    """Project world points [N,3] -> (pixel xy [N,2], cam depth [N])."""
    M = world_to_pix3(cam)
    hom = pts @ M[:, :3].T + M[:, 3]
    z = hom[:, 2]
    return hom[:, :2] / torch.where(z == 0, torch.ones_like(z), z)[:, None], z
