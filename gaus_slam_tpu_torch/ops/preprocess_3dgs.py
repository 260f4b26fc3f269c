"""Per-gaussian preprocessing for the 3DGS (volumetric) render method
(port of gaus_slam_tpu/ops/preprocess_3dgs.py).

The EWA-splatting alpha op * exp(-0.5 d^T conic d), d = pix - mean2D, is
a quadratic form in the pixel. With the conic factored as U^T U
(Cholesky) it is the 2DGS compositor's ray-splat density sx^2 + sy^2
under the pixel-linear map (sx, sy) = (U00 dx + U01 dy, U11 dy). So the
3DGS method is this preprocess with the unchanged binning and the
unchanged compositing kernels (K1-K4), fed pair attributes of this form:

  * a0 / a1 / a2 encode U and mean2D with p_z == 1 (no perspective
    divide);
  * t_w = (0, 0, z_view), so the per-pixel depth is the constant
    camera-space z: the D / alpha channels are the reference's depth /
    silhouette without its second rasterization pass;
  * the +0.3 px EWA dilation bounds every conic eigenvalue by 1 / 0.3,
    under FILTER_INV_SQUARE, so the low-pass branch is never taken;
  * the normal is zero (the render facade zeroes middepth and dist).

The guards are the public 3DGS projection's: frustum cull z > 0.2, t/z
clamped to 1.3 tan(fov / 2), cov2D = J W Sigma W^T J^T + 0.3 I, cull on
det <= 0, radius = ceil(3 sqrt(lambda_max)) (detached). Gradients to
xyz, scales, quats and opacities flow through plain autograd.
"""
from __future__ import annotations

import torch

from .camera import Camera, world_to_pix3
from .preprocess import PreprocResult
from .se3 import quat_to_rotmat


def scales_to_3d(scales2: torch.Tensor, isotropic: bool) -> torch.Tensor:
    """[N, 2] activated surfel scales -> [N, 3] volumetric scales: the
    first column tiled to 3 when isotropic, else the two tangent scales
    and their geometric mean."""
    if isotropic:
        s = scales2[:, 0:1]
        return torch.cat([s, s, s], dim=-1)
    s2 = torch.sqrt(scales2[:, 0:1] * scales2[:, 1:2])
    return torch.cat([scales2, s2], dim=-1)


def preprocess_3dgs(xyz: torch.Tensor, scales3: torch.Tensor,
                    quats: torch.Tensor, opacities: torch.Tensor,
                    cam: Camera, active=None) -> PreprocResult:
    """[N, 3] world centres, [N, 3] activated scales, [N, 4] (w, x, y, z)
    quaternions and [N] activated opacities -> the EWA conic as a
    pixel-linear intersection map (PreprocResult)."""
    opacities = opacities.reshape(-1)
    w2c = cam.w2c.float()
    Rw = w2c[:3, :3]

    p_view = xyz @ Rw.T + w2c[:3, 3]
    tz = p_view[..., 2]
    valid = tz > 0.2
    tz_safe = torch.where(valid, tz, torch.ones_like(tz))

    # EWA projection of the 3D covariance
    R = quat_to_rotmat(quats)                        # [N, 3, 3]
    M = R * scales3[..., None, :]                    # columns scaled
    sigma = M @ M.transpose(-1, -2)                  # [N, 3, 3]

    limx = 1.3 * cam.width / (2.0 * cam.fx)
    limy = 1.3 * cam.height / (2.0 * cam.fy)
    txz = torch.clamp(p_view[..., 0] / tz_safe, -limx, limx)
    tyz = torch.clamp(p_view[..., 1] / tz_safe, -limy, limy)
    inv_z = 1.0 / tz_safe
    # J = [[fx/z, 0, -fx*tx/z^2], [0, fy/z, -fy*ty/z^2]]  (2x3)
    j00 = cam.fx * inv_z
    j11 = cam.fy * inv_z
    j02 = -cam.fx * txz * inv_z
    j12 = -cam.fy * tyz * inv_z
    zeros = torch.zeros_like(j00)
    J = torch.stack([torch.stack([j00, zeros, j02], -1),
                     torch.stack([zeros, j11, j12], -1)], -2)   # [N, 2, 3]
    T = J @ Rw                                       # [N, 2, 3]
    cov2d = T @ sigma @ T.transpose(-1, -2)          # [N, 2, 2]
    a = cov2d[..., 0, 0] + 0.3
    b = cov2d[..., 0, 1]
    c = cov2d[..., 1, 1] + 0.3
    det = a * c - b * b
    valid = valid & (det > 0.0)
    det_safe = torch.where(det > 0.0, det, torch.ones_like(det))

    # conic = [[c, -b], [-b, a]] / det = U^T U, U = [[u00, u01], [0, u11]]:
    #   u00^2 = conic_xx, u00 * u01 = conic_xy, u01^2 + u11^2 = conic_yy
    ca = c / det_safe
    cb = -b / det_safe
    cc = a / det_safe
    u00 = torch.sqrt(torch.clamp(ca, min=1e-12))
    u01 = cb / u00
    u11 = torch.sqrt(torch.clamp(cc - u01 * u01, min=1e-12))

    # mean2D in pixel coordinates (the compositor's ndc2pix convention)
    Mpix = world_to_pix3(cam)
    hom = xyz @ Mpix[:, :3].T + Mpix[:, 3]
    zc = torch.where(hom[..., 2] == 0.0, torch.ones_like(hom[..., 2]),
                     hom[..., 2])
    mx = hom[..., 0] / zc
    my = hom[..., 1] / zc

    # the pixel-linear map (sx, sy) = U (pix - mean2D), p_z == 1
    zeros = torch.zeros_like(mx)
    ones = torch.ones_like(mx)
    a0 = torch.stack([u00, zeros, zeros], -1)
    a1 = torch.stack([u01, u11, zeros], -1)
    a2 = torch.stack([-(u00 * mx + u01 * my), -u11 * my, ones], -1)
    t_w = torch.stack([zeros, zeros, tz], -1)        # constant ray depth

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))

    if active is not None:
        valid = valid & active

    return PreprocResult(
        valid=valid,
        t_u=torch.zeros_like(a0), t_v=torch.zeros_like(a0), t_w=t_w,
        a0=a0, a1=a1, a2=a2,
        normal=torch.zeros_like(a0),
        center=torch.stack([mx, my], -1),
        radius=radius.detach(),
        depth=tz, opacity=opacities,
    )
