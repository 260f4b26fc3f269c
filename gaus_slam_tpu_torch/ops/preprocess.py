"""Per-gaussian preprocessing for the 2DGS surfel rasterizer
(port of gaus_slam_tpu/ops/preprocess.py).

Differentiable w.r.t. (xyz, scales, quats, opacities) and the camera
pose inside ``cam.w2c``; every ``lax.stop_gradient`` of the JAX version
is a ``.detach()`` at the same place. ``preprocess`` is the [N, C]
oracle, ``preprocess_t`` the lane-major production path that returns
the [PAIR_C, N] kernel attribute slab directly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .camera import CUTOFF, Camera, world_to_pix3
from .consts import constant
from .se3 import quat_to_rotmat


class PreprocResult(NamedTuple):
    valid: torch.Tensor    # [N] bool
    t_u: torch.Tensor      # [N, 3]
    t_v: torch.Tensor      # [N, 3]
    t_w: torch.Tensor      # [N, 3]
    a0: torch.Tensor       # [N, 3]
    a1: torch.Tensor       # [N, 3]
    a2: torch.Tensor       # [N, 3]
    normal: torch.Tensor   # [N, 3]
    center: torch.Tensor   # [N, 2]
    radius: torch.Tensor   # [N] float
    depth: torch.Tensor    # [N]
    opacity: torch.Tensor  # [N]


def _sign_flip(cosv: torch.Tensor) -> torch.Tensor:
    return torch.where(cosv > 0, 1.0, -1.0).to(cosv.dtype).detach()


def preprocess(xyz, scales, quats, opacities, cam: Camera,
               active=None) -> PreprocResult:
    opacities = opacities.reshape(-1)
    w2c = cam.w2c.float()
    R = quat_to_rotmat(quats)
    L0 = R[..., :, 0] * scales[..., 0:1]
    L1 = R[..., :, 1] * scales[..., 1:2]
    normal_world = R[..., :, 2]

    p_view = xyz @ w2c[:3, :3].T + w2c[:3, 3]
    valid = p_view[..., 2] > 0.2

    M = world_to_pix3(cam)
    Mr, Mt = M[:, :3], M[:, 3]
    hu = L0 @ Mr.T
    hv = L1 @ Mr.T
    hp = xyz @ Mr.T + Mt
    t_u = torch.stack([hu[..., 0], hv[..., 0], hp[..., 0]], dim=-1)
    t_v = torch.stack([hu[..., 1], hv[..., 1], hp[..., 1]], dim=-1)
    t_w = torch.stack([hu[..., 2], hv[..., 2], hp[..., 2]], dim=-1)

    a0 = torch.linalg.cross(t_v, t_w, dim=-1)
    a1 = torch.linalg.cross(t_w, t_u, dim=-1)
    a2 = torch.linalg.cross(t_u, t_v, dim=-1)

    normal_cam = normal_world @ w2c[:3, :3].T
    cosv = -torch.sum(p_view * normal_cam, dim=-1)
    valid = valid & (cosv != 0.0)
    normal_cam = normal_cam * _sign_flip(cosv)[..., None]

    c2 = CUTOFF * CUTOFF
    tmp = constant((c2, c2, -1.0), torch.float32, xyz.device)
    distance = torch.sum(t_w * t_w * tmp, dim=-1)
    valid = valid & (distance != 0.0)
    safe_dist = torch.where(distance == 0.0, torch.ones_like(distance),
                            distance)
    f = tmp / safe_dist[..., None]
    center = torch.stack(
        [torch.sum(f * t_u * t_w, dim=-1), torch.sum(f * t_v * t_w, dim=-1)],
        dim=-1,
    )
    temp = torch.stack(
        [torch.sum(f * t_u * t_u, dim=-1), torch.sum(f * t_v * t_v, dim=-1)],
        dim=-1,
    )
    half_extend = center * center - temp
    extent = torch.sqrt(torch.clamp(half_extend, min=1e-4))
    radius = torch.ceil(torch.maximum(extent[..., 0], extent[..., 1]))

    if active is not None:
        valid = valid & active

    return PreprocResult(
        valid=valid, t_u=t_u, t_v=t_v, t_w=t_w, a0=a0, a1=a1, a2=a2,
        normal=normal_cam, center=center, radius=radius.detach(),
        depth=p_view[..., 2], opacity=opacities,
    )


class PreSummary(NamedTuple):
    """The preprocess outputs binning consumes."""

    valid: torch.Tensor    # [N] bool
    center: torch.Tensor   # [N, 2]
    radius: torch.Tensor   # [N] float
    depth: torch.Tensor    # [N]


def preprocess_t(xyz_t, scales_t, quats_t, opacities, colors_t, cam: Camera,
                 active=None):
    """Transposed preprocess: same math as ``preprocess`` +
    ``pack_pair_attrs`` on [C, N] rows; returns ([PAIR_C, N] attrs,
    PreSummary)."""
    w2c = cam.w2c.float()
    qw, qx, qy, qz = quats_t[0], quats_t[1], quats_t[2], quats_t[3]
    n2 = qw * qw + qx * qx + qy * qy + qz * qz
    s = 2.0 / torch.clamp(n2, min=1e-24)
    r00 = 1.0 - s * (qy * qy + qz * qz)
    r01 = s * (qx * qy - qw * qz)
    r02 = s * (qx * qz + qw * qy)
    r10 = s * (qx * qy + qw * qz)
    r11 = 1.0 - s * (qx * qx + qz * qz)
    r12 = s * (qy * qz - qw * qx)
    r20 = s * (qx * qz - qw * qy)
    r21 = s * (qy * qz + qw * qx)
    r22 = 1.0 - s * (qx * qx + qy * qy)

    s0, s1 = scales_t[0], scales_t[1]
    L0 = (r00 * s0, r10 * s0, r20 * s0)
    L1 = (r01 * s1, r11 * s1, r21 * s1)
    nw = (r02, r12, r22)

    def mat_rows(M, v, translate=False):
        out = []
        for i in range(3):
            r = M[i, 0] * v[0] + M[i, 1] * v[1] + M[i, 2] * v[2]
            if translate:
                r = r + M[i, 3]
            out.append(r)
        return out

    xyz3 = (xyz_t[0], xyz_t[1], xyz_t[2])
    pv = mat_rows(w2c, xyz3, translate=True)
    valid = pv[2] > 0.2

    M = world_to_pix3(cam)
    hu = mat_rows(M, L0)
    hv = mat_rows(M, L1)
    hp = mat_rows(M, xyz3, translate=True)
    tu = (hu[0], hv[0], hp[0])
    tv = (hu[1], hv[1], hp[1])
    tw = (hu[2], hv[2], hp[2])

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    a0 = cross(tv, tw)
    a1 = cross(tw, tu)
    a2 = cross(tu, tv)

    nc = mat_rows(w2c, nw)
    cosv = -(pv[0] * nc[0] + pv[1] * nc[1] + pv[2] * nc[2])
    valid = valid & (cosv != 0.0)
    flip = _sign_flip(cosv)
    nc = (nc[0] * flip, nc[1] * flip, nc[2] * flip)

    c2 = CUTOFF * CUTOFF
    distance = c2 * (tw[0] * tw[0] + tw[1] * tw[1]) - tw[2] * tw[2]
    valid = valid & (distance != 0.0)
    inv_d = 1.0 / torch.where(distance == 0.0, torch.ones_like(distance),
                              distance)
    cx = (c2 * (tu[0] * tw[0] + tu[1] * tw[1]) - tu[2] * tw[2]) * inv_d
    cy = (c2 * (tv[0] * tw[0] + tv[1] * tw[1]) - tv[2] * tw[2]) * inv_d
    tempx = (c2 * (tu[0] * tu[0] + tu[1] * tu[1]) - tu[2] * tu[2]) * inv_d
    tempy = (c2 * (tv[0] * tv[0] + tv[1] * tv[1]) - tv[2] * tv[2]) * inv_d
    ex = torch.sqrt(torch.clamp(cx * cx - tempx, min=1e-4))
    ey = torch.sqrt(torch.clamp(cy * cy - tempy, min=1e-4))
    radius = torch.ceil(torch.maximum(ex, ey)).detach()

    if active is not None:
        valid = valid & active
    opac = torch.where(valid, opacities, torch.zeros_like(opacities))
    zeros = torch.zeros_like(opac)
    attrs = torch.stack([
        a0[0], a0[1], a0[2], a1[0], a1[1], a1[2], a2[0], a2[1], a2[2],
        tw[0], tw[1], tw[2],
        cx.detach(), cy.detach(),
        nc[0], nc[1], nc[2], opac,
        colors_t[0], colors_t[1], colors_t[2],
        zeros, zeros, zeros,
    ], dim=0)
    summary = PreSummary(
        valid=valid, center=torch.stack([cx, cy], dim=-1),
        radius=radius, depth=pv[2],
    )
    return attrs, summary


# Pair-attribute packing used by the compositing kernels.
# Layout [PAIR_C, R]: per-pair scalars on rows, pairs along the row.
PAIR_FIELDS = (
    "a0x a0y a0z a1x a1y a1z a2x a2y a2z "
    "twx twy twz cx cy nx ny nz op r g b pad0 pad1 pad2"
).split()
PAIR_C = len(PAIR_FIELDS)  # 24


def pack_pair_attrs(pre: PreprocResult, colors: torch.Tensor) -> torch.Tensor:
    """Stack preprocess outputs + colors into the [PAIR_C, N] kernel
    layout. Invalid gaussians are zeroed (opacity=0); the low-pass
    filter center is detached (it feeds only the densification stat in
    the reference backward)."""
    opac = torch.where(pre.valid, pre.opacity, torch.zeros_like(pre.opacity))
    zeros = torch.zeros_like(opac)
    rows = [
        pre.a0[:, 0], pre.a0[:, 1], pre.a0[:, 2],
        pre.a1[:, 0], pre.a1[:, 1], pre.a1[:, 2],
        pre.a2[:, 0], pre.a2[:, 1], pre.a2[:, 2],
        pre.t_w[:, 0], pre.t_w[:, 1], pre.t_w[:, 2],
        pre.center[:, 0].detach(), pre.center[:, 1].detach(),
        pre.normal[:, 0], pre.normal[:, 1], pre.normal[:, 2],
        opac,
        colors[:, 0], colors[:, 1], colors[:, 2],
        zeros, zeros, zeros,
    ]
    return torch.stack(rows, dim=0)
