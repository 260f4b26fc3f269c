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

from ..ops.consts import (at, div_by_entry, host_scalar_divisor,
                          host_to_device, step_table)
from ..ops.se3 import pose_matrix, pose_params_from_matrix


def _f32_pow(b: float, step: int) -> float:
    """b ** step in float32, as the JAX version evaluates bias
    corrections."""
    return float(torch.tensor(b, dtype=torch.float32)
                 ** torch.tensor(float(step), dtype=torch.float32))


def saturation_step(b: float) -> int:
    """An Adam step from which on b ** t < 2 ** -30: far under the
    2 ** -25 at which 1 - b ** t rounds to 1.0 in float32, so a bias
    correction table ends there and its last entry holds for good."""
    return int(np.ceil(-30 * np.log(2) / np.log(b))) + 1


def bias_table(b: float, device) -> torch.Tensor:
    """The divisors of the bias correction 1 - b ** t for the device Adam
    steps t = 0 .. saturation_step(b), each from the host arithmetic the
    step used before it moved to the device (``_f32_pow``, then 1 - in
    double) as ``device`` divides by it; t = 0 is never read."""
    n = saturation_step(b)

    def entries():
        assert np.float32(1 - _f32_pow(b, n)) == 1.0, (b, n)
        return [1.0] + [host_scalar_divisor(1 - _f32_pow(b, t), device)
                        for t in range(1, n + 1)]
    return step_table(("pose_bias", float(b)), entries, device)


def lr_table(sched, device) -> torch.Tensor:
    """``sched.at(k)`` for k = 0 .. max(max_steps, 1), where it stops
    moving."""
    n = max(int(sched.max_steps), 1)
    return step_table(("lr",) + tuple(sched),
                      lambda: [sched.at(k) for k in range(n + 1)], device)


def zero_step(device) -> torch.Tensor:
    """A fresh Adam step counter: a device int32 scalar, as in JAX."""
    return torch.zeros((), dtype=torch.int32, device=device)


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
    step: torch.Tensor   # device int32 Adam step count

    @property
    def w2c(self) -> torch.Tensor:
        return pose_matrix(self.quat, self.trans)


def _fresh_pose(q: torch.Tensor, t: torch.Tensor) -> PoseState:
    z4, z3 = torch.zeros_like(q), torch.zeros_like(t)
    return PoseState(q, t, z4, z4.clone(), z3, z3.clone(), zero_step(q.device))


def init_pose(initial_w2c, device="cuda") -> PoseState:
    q, t = pose_params_from_matrix(
        torch.as_tensor(initial_w2c, dtype=torch.float32, device=device))
    # the translation on its own (not a column view of the matrix): a
    # captured step is keyed by its arguments' layouts (slam/programs.py),
    # and an Adam step's pose is laid out so
    return _fresh_pose(q, t.contiguous())


def pose_adam_step(ps: PoseState, g_quat, g_trans, rot_sched: LrSchedule,
                   trans_sched: LrSchedule, betas=(0.7, 0.99),
                   eps: float = 1e-8) -> PoseState:
    """One Adam step of the pose. Its bias corrections and learning rates
    come from tables indexed by the device step (lr used at iteration k
    is sched(k)), so the step reads no host value that changes per step."""
    b1, b2 = betas
    dev = ps.quat.device
    step = ps.step + 1
    d1, d2 = at(bias_table(b1, dev), step), at(bias_table(b2, dev), step)
    lr_q = at(lr_table(rot_sched, dev), ps.step)
    lr_t = at(lr_table(trans_sched, dev), ps.step)

    def upd(p, m, v, g, lr):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        return p - lr * div_by_entry(m, d1) / (
            torch.sqrt(div_by_entry(v, d2)) + eps), m, v

    q, m_q, v_q = upd(ps.quat, ps.m_q, ps.v_q, g_quat, lr_q)
    tr, m_t, v_t = upd(ps.trans, ps.m_t, ps.v_t, g_trans, lr_t)
    return PoseState(q, tr, m_q, v_q, m_t, v_t, step)


class ExposureState(NamedTuple):
    gain: torch.Tensor   # scalar
    bias: torch.Tensor   # scalar
    m: torch.Tensor      # [2]
    v: torch.Tensor      # [2]
    step: torch.Tensor   # device int32 Adam step count

    def apply(self, img):
        return self.gain * img + self.bias


def init_exposure(device="cuda") -> ExposureState:
    # filled on the device (a host scalar copied there would wait)
    return ExposureState(
        torch.ones((), device=device), torch.zeros((), device=device),
        torch.zeros(2, device=device), torch.zeros(2, device=device),
        zero_step(device),
    )


def exposure_adam_step(es: ExposureState, g_gain, g_bias, sched: LrSchedule,
                       betas=(0.9, 0.99), eps: float = 1e-8) -> ExposureState:
    b1, b2 = betas
    dev = es.m.device
    step = es.step + 1
    d1, d2 = at(bias_table(b1, dev), step), at(bias_table(b2, dev), step)
    lr = at(lr_table(sched, dev), es.step)
    g = torch.stack([g_gain, g_bias])
    m = b1 * es.m + (1 - b1) * g
    v = b2 * es.v + (1 - b2) * g * g
    upd = lr * div_by_entry(m, d1) / (torch.sqrt(div_by_entry(v, d2)) + eps)
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
