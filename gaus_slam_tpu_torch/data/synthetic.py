"""Procedural synthetic RGB-D sequences (no external data needed).

A copy of gaus_slam_tpu/data/synthetic.py (numpy only), kept here so the
port never imports the JAX package.

Renders the interior of a textured axis-aligned box analytically
(ray/plane intersections -> exact depth, smooth multi-frequency texture
-> trackable photometric gradients). Used by tests and benchmarks as a
stand-in for Replica-style trajectories; follows the dataset interface
of the reference loaders (color in 0..255 float, depth in meters,
intrinsics 4x4, c2w 4x4).
"""
from __future__ import annotations

import numpy as np


def _texture(u, v, wall_id):
    """Smooth deterministic RGB texture on wall-local coords (meters)."""
    p = 2.0 * np.pi
    r = 0.5 + 0.25 * np.sin(p * (0.7 * u + 0.23 * wall_id)) \
        + 0.25 * np.sin(p * (0.31 * v + 0.8))
    g = 0.5 + 0.25 * np.sin(p * (0.43 * u - 0.17 * v + 0.5 * wall_id)) \
        + 0.25 * np.cos(p * 0.57 * v)
    b = 0.5 + 0.25 * np.cos(p * (0.29 * u + 0.61 * v)) \
        + 0.25 * np.sin(p * (0.13 * u + 0.37 * wall_id))
    return np.stack([r, g, b], axis=-1)


class SyntheticDataset:
    """Camera panning inside a box of half-extents ``half`` centred at 0."""

    def __init__(self, height=120, width=160, fx=None, fy=None,
                 num_frames=40, half=(3.0, 2.0, 3.0), seed=0,
                 motion="orbit"):
        self.h, self.w = height, width
        self.fx = fx or width * 0.6
        self.fy = fy or width * 0.6
        self.cx, self.cy = width / 2.0, height / 2.0
        self.num_frames = num_frames
        self.half = np.asarray(half, np.float64)
        self.motion = motion
        rng = np.random.default_rng(seed)
        self._poses = [self._pose(i) for i in range(num_frames)]

    def __len__(self):
        return self.num_frames

    @property
    def intrinsics(self):
        k = np.eye(4, dtype=np.float32)
        k[0, 0], k[1, 1], k[0, 2], k[1, 2] = self.fx, self.fy, self.cx, self.cy
        return k

    def _pose(self, i):
        """c2w for frame i: slow pan + small translation."""
        t = i / max(self.num_frames - 1, 1)
        if self.motion == "orbit":
            ang = 0.35 * np.sin(2 * np.pi * t * 0.5)
            pos = np.array([0.8 * np.sin(2 * np.pi * t * 0.3),
                            0.2 * np.sin(2 * np.pi * t * 0.7),
                            -0.5 + 0.8 * t])
        else:  # forward
            ang = 0.1 * t
            pos = np.array([0.0, 0.0, -1.0 + 1.5 * t])
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])  # yaw
        c2w = np.eye(4)
        c2w[:3, :3] = R
        c2w[:3, 3] = pos
        return c2w

    def render_frame(self, c2w):
        h, w = self.h, self.w
        xs = (np.arange(w) - self.cx) / self.fx
        ys = (np.arange(h) - self.cy) / self.fy
        dx, dy = np.meshgrid(xs, ys)
        dirs_cam = np.stack([dx, dy, np.ones_like(dx)], axis=-1)
        R, o = c2w[:3, :3], c2w[:3, 3]
        dirs = dirs_cam @ R.T                      # [H, W, 3] world
        tbest = np.full((h, w), np.inf)
        wallbest = np.zeros((h, w), np.int32)
        for axis in range(3):
            for sgn in (-1.0, 1.0):
                d = dirs[..., axis]
                denom = np.where(np.abs(d) < 1e-9, 1e-9, d)
                t = (sgn * self.half[axis] - o[axis]) / denom
                ok = t > 1e-6
                # the hit must be inside the box on the other two axes
                hit = o[None, None, :] + t[..., None] * dirs
                inside = np.ones_like(ok)
                for a2 in range(3):
                    if a2 == axis:
                        continue
                    inside &= np.abs(hit[..., a2]) <= self.half[a2] + 1e-6
                better = ok & inside & (t < tbest)
                tbest = np.where(better, t, tbest)
                wallbest = np.where(better, axis * 2 + (sgn > 0), wallbest)
        hit = o[None, None, :] + tbest[..., None] * dirs
        # wall-local texture coords: the two non-normal axes
        u = np.zeros((h, w))
        v = np.zeros((h, w))
        for wid in range(6):
            axis = wid // 2
            a, b = [x for x in range(3) if x != axis]
            m = wallbest == wid
            u = np.where(m, hit[..., a], u)
            v = np.where(m, hit[..., b], v)
        color = np.clip(_texture(u, v, wallbest.astype(np.float64)), 0, 1)
        # camera-space depth (z, not ray length)
        depth = tbest * dirs_cam[..., 2]
        return color.astype(np.float32), depth.astype(np.float32)

    def __getitem__(self, i):
        c2w = self._poses[i]
        color, depth = self.render_frame(c2w)
        return (
            color * 255.0,
            depth,
            self.intrinsics.copy(),
            c2w.astype(np.float32),
        )
