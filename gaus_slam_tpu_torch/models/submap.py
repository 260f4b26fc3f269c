"""Submap containers (port of gaus_slam_tpu/models/submap.py; reference
scene/Frame.py:202-322).

A LocalMap freezes a frontend submap at cut time: it rebases all frame
poses to be relative to the first frame (so the backend can re-pose the
whole submap with a single rigid transform), selects which frames keep
their images (randomized priority with first/last/keyframe boosting),
snapshots the local map parameters, and computes the covisibility
descriptor from two representative images.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.consts import host_to_device
from ..ops.se3 import pose_matrix
from ..utils import trace
from .descriptor import describe_frames, query_covisible
from .frame import ExposureState, PoseState, init_exposure, init_pose


@dataclass
class LocalMap:
    lmid: int
    frames: list                      # list[Frame]
    map_params: object                # (Params, active, n_active) snapshot
    tracking_ok: bool = True
    saved_idxs: list = field(default_factory=list)
    ref2f0: np.ndarray | None = None  # first frame's w2c at cut time
    transform: PoseState | None = None
    # per-submap exposure (scene/Frame.py:241-243), stepped by the backend
    exposure: ExposureState | None = None
    map_desc: object = None           # [reps, D] host array
    mapping_times: int = 0
    # host mirror of map_params' n_active, set at cut time
    n_active_host: int | None = None

    @classmethod
    def cut(cls, lmid, frames, map_params, num_frame_saved,
            tracking_ok=True, rng: random.Random | None = None,
            n_active_host: int | None = None):
        """Freeze a submap (LocalMap.__init__, scene/Frame.py:210-257)."""
        rng = rng or random
        lm = cls(lmid=lmid, frames=frames, map_params=map_params,
                 tracking_ok=tracking_ok, n_active_host=n_active_host)

        # randomized retention priority: first/last boosted by 400,
        # keyframes by 200 (Frame.py:210-218)
        pri = [rng.randint(0, 100) for _ in frames[:-1]]
        if pri:
            pri[0] += 400
            pri[-1] += 400
            for i in range(len(pri)):
                pri[i] += (frames[i].frame_type < 2) * 200
        order = sorted(range(len(pri)), key=lambda x: pri[x], reverse=True)
        lm.saved_idxs = order[: min(num_frame_saved, len(order))]

        # descriptor from two representative images BEFORE freeing data
        reps = [frames[0].gt_color, frames[max(len(frames) - 2, 0)].gt_color]
        desc = describe_frames(reps)
        with trace.span("frontend.wait"):
            lm.map_desc = desc.cpu().numpy()
        posed = [f for f in frames if f.pose is not None]
        if posed:
            w2cs = torch.stack([pose_matrix(f.pose.quat, f.pose.trans)
                                for f in posed])
            with trace.span("frontend.wait"):
                w2cs = w2cs.cpu().numpy()
            for f, w2c in zip(posed, w2cs):
                f.est_w2c = w2c
                f.pose = None
        for f in frames:
            if f.exposure is not None:
                f.est_exposure = (float(f.exposure.gain),
                                  float(f.exposure.bias))
                f.exposure = None

        # rebase poses submap-relative (Frame.py:220-224)
        ref2f0 = frames[0].est_w2c.copy()
        R, t = ref2f0[:3, :3], ref2f0[:3, 3]
        f02ref = np.eye(4, dtype=np.float32)    # SE3 inverse, on the host
        f02ref[:3, :3] = R.T
        f02ref[:3, 3] = -R.T @ t
        lm.ref2f0 = ref2f0
        for idx, fr in enumerate(frames):
            fr.finish_optimizer(save=(idx in lm.saved_idxs))
            fr.est_w2c = fr.est_w2c @ f02ref
        return lm

    def start_optimizer(self, initial_w2c, enable_exposure: bool = False,
                        device="cuda"):
        self.transform = init_pose(initial_w2c, device=device)
        if enable_exposure:
            self.exposure = init_exposure(device)

    def frame_exp(self, f_idx) -> np.ndarray:
        """The frame's frozen (gain, bias) as a host [2] array."""
        g, b = self.frames[f_idx].est_exposure
        return np.asarray([g, b], np.float32)

    def get_frame_w2c(self, f_idx) -> torch.Tensor:
        """Composed pose: frame-in-submap @ submap transform
        (Frame.py:246-248)."""
        assert self.transform is not None
        q = self.transform.quat
        est = host_to_device(self.frames[f_idx].est_w2c, q.device)
        return est @ pose_matrix(q, self.transform.trans)

    @property
    def get_w2c(self) -> torch.Tensor:
        assert self.transform is not None
        return self.transform.w2c


class Localmaps(list):
    """Submap list + descriptor matrix + covisibility query
    (scene/Frame.py:264-322)."""

    def __init__(self):
        super().__init__()
        self.map_descs = None  # host [num, reps, D]

    def add_localmap(self, lm: LocalMap):
        self.append(lm)
        d = lm.map_desc[None]
        self.map_descs = d if self.map_descs is None else np.concatenate(
            [self.map_descs, d])

    def query_covisable(self, lm_idx: int, num_kf: int = 10):
        return query_covisible(self.map_descs, self.map_descs[lm_idx], num_kf)

    def _frames_in_time_order(self):
        """(LocalMap, Frame) of every frame once, in time order: each
        submap's frames but its last (the next submap's first), then the
        last frame of the last submap (Frame.py:298-308)."""
        out = []
        for lm in self:
            for f in lm.frames[:-1]:
                if f.time_idx == len(out) and lm.transform is not None:
                    out.append((lm, f))
        out.append((self[-1], self[-1].frames[-1]))
        return out

    def get_w2cs(self):
        """Per-frame estimated w2cs (frame-in-submap @ submap transform),
        host float32 arrays in time order."""
        pairs = self._frames_in_time_order()
        est = torch.stack([torch.as_tensor(f.est_w2c, dtype=torch.float32)
                           for _, f in pairs])
        tf = torch.stack([lm.get_w2c.detach() for lm, _ in pairs])
        return list((est.to(tf.device) @ tf).cpu().numpy())

    def get_gt_w2cs(self):
        return [np.asarray(f.gt_w2c) for _, f in self._frames_in_time_order()]
