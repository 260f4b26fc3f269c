"""Per-frame optimizable state and the host-side frame record (port of
gaus_slam_tpu/models/frame.py).

Pose = quaternion (w,x,y,z) + translation with per-group Adam and a
learning rate linearly interpolated from init to final over max_steps;
exposure = affine (gain, bias) color correction with its own Adam.
``Frame`` holds a frame's ground truth and its lifecycle (images freed
after the submap is cut unless the frame is one of the saved ones).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..ops.consts import host_to_device
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
    # filled on the device (a host scalar copied there would wait)
    return ExposureState(
        torch.ones((), device=device), torch.zeros((), device=device),
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


@dataclass
class Frame:
    """Host-side per-frame record (scene/Frame.py:140-199). Its pose and
    exposure live on ``device``; ``_w2c_host`` mirrors the pose on the
    host (set by start_optimizer and by the frontend's tracking
    readback)."""

    time_idx: int
    gt_color: object        # [H, W, 3] float 0-1 tensor (None after free)
    gt_depth: object        # [H, W] meters
    gt_w2c: np.ndarray      # [4, 4] ground truth (for eval only)
    kfid: int = 0
    # scene/Frame.py codes: 0 reference keyframe, 1 keyframe, 2 ordinary
    frame_type: int = 2
    pose: PoseState | None = None
    exposure: ExposureState | None = None
    est_w2c: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    est_exposure: tuple = (1.0, 0.0)
    mapping_times: int = 0
    device: object = "cuda"

    def start_optimizer(self, initial_w2c, enable_exposure=False):
        self.pose = init_pose(initial_w2c, device=self.device)
        self._w2c_host = np.asarray(initial_w2c, dtype=np.float32)
        if enable_exposure:
            self.exposure = init_exposure(self.device)

    def finish_optimizer(self, save: bool = False):
        """Freeze pose into est_w2c; free images unless saved
        (Frame.py:175-187)."""
        if self.pose is not None:
            self.est_w2c = self.pose.w2c.detach().cpu().numpy()
            self.pose = None
        if self.exposure is not None:
            self.est_exposure = (float(self.exposure.gain),
                                 float(self.exposure.bias))
            self.exposure = None
        if not save:
            self.gt_color = None
            self.gt_depth = None
            if hasattr(self, "gt_tiled"):
                self.gt_tiled = None

    @property
    def get_w2c(self) -> torch.Tensor:
        if self.pose is not None:
            return self.pose.w2c
        return host_to_device(self.est_w2c, self.device)
