"""The cell's camera stream: every distinct frame of a traffic mix rendered
once on the device from the seed, kept in host memory as the camera
stores it (uint8 colour, uint16 depth), and read as a dataset loader
returns it (colour 0..255 and depth in metres, float32, widened on each
read)."""
from __future__ import annotations

import numpy as np
import torch

from .reference import boxscene


class FrameStream:
    """``stream[t]`` -> (colour, depth, intrinsics 4x4, c2w) of sequence
    position ``t``, the dataset interface of the port's loaders."""

    def __init__(self, camera: dict, traffic: dict, seed: int, device):
        self.camera = camera
        self.poses = boxscene.pass_poses(traffic)
        self.n = len(self.poses)
        self.phases = boxscene.texture_phases(seed)
        self.start = int(traffic.get("start", 0))
        half = traffic.get("box_half", (3.0, 2.0, 3.0))
        scale = float(camera["depth_scale"])
        self.depth_scale = np.float32(scale)
        self.color8, self.depth16 = [], []
        for c2w in self.poses:
            color, depth = boxscene.render_frame(c2w, camera, half,
                                                 self.phases, device)
            c8, d16 = boxscene.quantize(color, depth, scale)
            self.color8.append(c8)
            self.depth16.append(d16)
        k = np.eye(4, dtype=np.float32)
        k[0, 0], k[1, 1] = camera["fx"], camera["fy"]
        k[0, 2], k[1, 2] = camera["cx"], camera["cy"]
        self.intrinsics = k

    def index(self, t: int) -> int:
        """Pose index of sequence position ``t``."""
        return boxscene.pass_index(self.start + t, self.n)

    def c2w(self, t: int) -> np.ndarray:
        return self.poses[self.index(t)]

    def __len__(self):
        return 1 << 40

    def __getitem__(self, t: int):
        i = self.index(t)
        color = self.color8[i].astype(np.float32)
        depth = self.depth16[i].astype(np.float32) / self.depth_scale
        return (color, depth, self.intrinsics.copy(),
                self.poses[i].astype(np.float32))

    def truth(self, t: int) -> tuple:
        """(colour [H, W, 3] in 0..1, depth [H, W] metres) as torch
        float32 tensors: what the camera saw at position ``t``."""
        i = self.index(t)
        color = torch.from_numpy(self.color8[i].astype(np.float32) / 255.0)
        depth = torch.from_numpy(self.depth16[i].astype(np.float32)
                                 / self.depth_scale)
        return color, depth
