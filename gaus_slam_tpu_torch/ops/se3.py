"""Quaternion / rotation / SE(3) primitives (port of gaus_slam_tpu/ops/se3.py).

Quaternions are (w, x, y, z), scalar first; rotations act on column
vectors; poses are 4x4 world-to-camera (w2c). Batched over leading dims.
"""
from __future__ import annotations

import torch

from .consts import constant


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) (w,x,y,z) -> rotation matrix [..., 3, 3]; scale
    invariant."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    s = 2.0 / torch.clamp((q * q).sum(-1), min=1e-24)
    R = torch.stack(
        [
            1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y),
            s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x),
            s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion (w,x,y,z), branch-free
    Shepperd method, canonical sign w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)

    cw = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cx = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1)
    cy = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1)
    cz = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1)

    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(mags, dim=-1)
    cands = torch.stack([cw, cx, cy, cz], dim=-2)  # [..., 4cand, 4]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = quat_normalize(q)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2. Broadcasts."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        ],
        dim=-1,
    )


def quat_multiply_rows(q1: torch.Tensor, q2_rows: torch.Tensor) -> torch.Tensor:
    """Hamilton product of one quaternion ``q1`` [4] with [4, R] rows."""
    w1, x1, y1, z1 = q1[0], q1[1], q1[2], q1[3]
    w2, x2, y2, z2 = q2_rows[0], q2_rows[1], q2_rows[2], q2_rows[3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        ],
        dim=0,
    )


def _bottom_row(like: torch.Tensor) -> torch.Tensor:
    b = constant((0.0, 0.0, 0.0, 1.0), like.dtype, like.device)
    return b.expand(like.shape[:-2] + (1, 4))


def pose_matrix(quat: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(quat[4], trans[3]) -> 4x4 transform; the quaternion is normalized
    first, so gradients flow through the normalization."""
    R = quat_to_rotmat(quat_normalize(quat))
    top = torch.cat([R, trans[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def pose_params_from_matrix(m: torch.Tensor):
    """4x4 transform -> (quat[4], trans[3])."""
    return rotmat_to_quat(m[..., :3, :3]), m[..., :3, 3]


def invert_se3(m: torch.Tensor) -> torch.Tensor:
    """Invert a rigid 4x4 transform without a general solve."""
    R = m[..., :3, :3]
    t = m[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, t)
    top = torch.cat([Rt, ti[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def transform_points(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 (or 3x4) transform to [..., N, 3] points."""
    return pts @ m[..., :3, :3].transpose(-1, -2) + m[..., None, :3, 3]
