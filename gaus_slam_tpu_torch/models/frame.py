"""Per-frame optimizable state: camera pose and exposure
(port of the state part of gaus_slam_tpu/models/frame.py).

Pose = quaternion (w,x,y,z) + translation with per-group Adam and a
learning rate linearly interpolated from init to final over max_steps;
exposure = affine (gain, bias) color correction with its own Adam.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.se3 import pose_matrix, pose_params_from_matrix


def _f32_pow(b: float, step: int) -> float:
    """b ** step in float32, as the JAX version evaluates bias
    corrections."""
    return float(torch.tensor(b, dtype=torch.float32)
                 ** torch.tensor(float(step), dtype=torch.float32))


class LrSchedule(NamedTuple):
    init: float
    final: float
    max_steps: int

    def at(self, step: int) -> float:
        """Linear interpolation, clamped."""
        t = torch.clamp(torch.tensor(float(step), dtype=torch.float32)
                        / max(float(self.max_steps), 1.0), 0.0, 1.0)
        return float((1.0 - t) * self.init + t * self.final)


class PoseState(NamedTuple):
    quat: torch.Tensor   # [4] (w,x,y,z)
    trans: torch.Tensor  # [3]
    m_q: torch.Tensor
    v_q: torch.Tensor
    m_t: torch.Tensor
    v_t: torch.Tensor
    step: int

    @property
    def w2c(self) -> torch.Tensor:
        return pose_matrix(self.quat, self.trans)


def _fresh_pose(q: torch.Tensor, t: torch.Tensor) -> PoseState:
    z4, z3 = torch.zeros_like(q), torch.zeros_like(t)
    return PoseState(q, t, z4, z4.clone(), z3, z3.clone(), 0)


def init_pose(initial_w2c, device="cuda") -> PoseState:
    q, t = pose_params_from_matrix(
        torch.as_tensor(initial_w2c, dtype=torch.float32, device=device))
    return _fresh_pose(q, t)


def pose_adam_step(ps: PoseState, g_quat, g_trans, rot_sched: LrSchedule,
                   trans_sched: LrSchedule, betas=(0.7, 0.99),
                   eps: float = 1e-8) -> PoseState:
    b1, b2 = betas
    step = ps.step + 1
    c1, c2 = 1 - _f32_pow(b1, step), 1 - _f32_pow(b2, step)
    lr_q = rot_sched.at(ps.step)     # lr used at iteration k is sched(k)
    lr_t = trans_sched.at(ps.step)

    def upd(p, m, v, g, lr):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        return p - lr * (m / c1) / (torch.sqrt(v / c2) + eps), m, v

    q, m_q, v_q = upd(ps.quat, ps.m_q, ps.v_q, g_quat, lr_q)
    tr, m_t, v_t = upd(ps.trans, ps.m_t, ps.v_t, g_trans, lr_t)
    return PoseState(q, tr, m_q, v_q, m_t, v_t, step)


class ExposureState(NamedTuple):
    gain: torch.Tensor   # scalar
    bias: torch.Tensor   # scalar
    m: torch.Tensor      # [2]
    v: torch.Tensor      # [2]
    step: int

    def apply(self, img):
        return self.gain * img + self.bias


def init_exposure(device="cuda") -> ExposureState:
    return ExposureState(
        torch.tensor(1.0, device=device), torch.tensor(0.0, device=device),
        torch.zeros(2, device=device), torch.zeros(2, device=device), 0,
    )


def exposure_adam_step(es: ExposureState, g_gain, g_bias, sched: LrSchedule,
                       betas=(0.9, 0.99), eps: float = 1e-8) -> ExposureState:
    b1, b2 = betas
    step = es.step + 1
    c1, c2 = 1 - _f32_pow(b1, step), 1 - _f32_pow(b2, step)
    lr = sched.at(es.step)
    g = torch.stack([g_gain, g_bias])
    m = b1 * es.m + (1 - b1) * g
    v = b2 * es.v + (1 - b2) * g * g
    upd = lr * (m / c1) / (torch.sqrt(v / c2) + eps)
    return ExposureState(es.gain - upd[0], es.bias - upd[1], m, v, step)
