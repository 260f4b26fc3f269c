"""The benchmark's scene: the interior of a textured axis-aligned box,
rendered analytically on the device, and the camera trajectories that
the traffic files parametrise.

A PyTorch copy of the port's ``data/synthetic.py`` box renderer (exact
depth from ray/plane intersections, a smooth multi-frequency texture),
frozen here so that the yardstick does not move with the program. Two
departures: the texture's six sine terms take phase offsets (zero gives
the port's texture), and the intrinsics are the camera's own (the port's
copy puts the principal point at the image centre).

A trajectory is the port's ``orbit`` motion, ``c2w(t)`` for t in [0, 1]
(a yaw swing, a sideways and vertical sway, a forward travel), walked
forward and back without end: positions 0, 1, ..., n-1, n-2, ..., 1, 0,
1, ... over ``frames_per_pass`` = n poses. With ``"timing": "cosine"``
pose i sits at orbit time (1 - cos(pi i / (n - 1))) / 2, so the camera
slows to a stop at each end and turns back smoothly, as a hand-held one
does; the mean motion a frame is that of uniform timing. With
``"uniform"`` pose i sits at i / (n - 1) and the camera reverses at full
speed between two frames.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# the port's orbit (data/synthetic.py::SyntheticDataset._pose)
ORBIT = dict(yaw_amp=0.35, yaw_cycles=0.5, x_amp=0.8, x_cycles=0.3,
             y_amp=0.2, y_cycles=0.7, z_start=-0.5, z_travel=0.8)
N_PHASES = 6


def orbit_c2w(t: float, p: dict) -> np.ndarray:
    """c2w [4, 4] float64 at orbit time ``t`` with parameters ``p``."""
    tau = 2 * math.pi * t
    ang = p["yaw_amp"] * math.sin(tau * p["yaw_cycles"])
    pos = np.array([p["x_amp"] * math.sin(tau * p["x_cycles"]),
                    p["y_amp"] * math.sin(tau * p["y_cycles"]),
                    p["z_start"] + p["z_travel"] * t])
    c, s = math.cos(ang), math.sin(ang)
    c2w = np.eye(4)
    c2w[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    c2w[:3, 3] = pos
    return c2w


def pass_poses(traffic: dict) -> list:
    """The ``frames_per_pass`` distinct poses of one pass (float64 c2w),
    covering orbit times 0 .. ``t_span``."""
    n = int(traffic["frames_per_pass"])
    span = float(traffic.get("t_span", 1.0))
    p = dict(ORBIT, **traffic.get("orbit", {}))
    u = [i / max(n - 1, 1) for i in range(n)]
    if traffic.get("timing", "uniform") == "cosine":
        u = [(1.0 - math.cos(math.pi * x)) / 2.0 for x in u]
    return [orbit_c2w(span * x, p) for x in u]


def pass_index(pos: int, n: int) -> int:
    """Pose index of sequence position ``pos`` on the forward-and-back
    walk over ``n`` poses (period 2n - 2)."""
    if n <= 1:
        return 0
    period = 2 * n - 2
    i = pos % period
    return i if i < n else period - i


def texture_phases(seed: int) -> np.ndarray:
    """The texture's phases [N_PHASES] from the seed: the one thing a seed
    changes. Every seed walks the same poses from the same start at the
    same speed (a start drawn from the seed put different halves of the
    walk into a run, and runs of one traffic then built global maps of
    42-74 GB peak memory and differed by 13% in frames/s)."""
    return np.random.default_rng(int(seed)).uniform(0.0, 2 * math.pi,
                                                    N_PHASES)


def _texture(u, v, wid, ph):
    p = 2.0 * math.pi
    r = (0.5 + 0.25 * torch.sin(p * (0.7 * u + 0.23 * wid) + ph[0])
         + 0.25 * torch.sin(p * (0.31 * v + 0.8) + ph[1]))
    g = (0.5 + 0.25 * torch.sin(p * (0.43 * u - 0.17 * v + 0.5 * wid) + ph[2])
         + 0.25 * torch.cos(p * 0.57 * v + ph[3]))
    b = (0.5 + 0.25 * torch.cos(p * (0.29 * u + 0.61 * v) + ph[4])
         + 0.25 * torch.sin(p * (0.13 * u + 0.37 * wid) + ph[5]))
    return torch.stack([r, g, b], dim=-1)


def render_frame(c2w, cam: dict, half, phases, device) -> tuple:
    """(colour [H, W, 3] float32 in 0..1, z-depth [H, W] float32 metres)
    of the box seen from ``c2w``; computed in float64 on ``device``."""
    f64 = torch.float64
    h, w = int(cam["h"]), int(cam["w"])
    xs = (torch.arange(w, dtype=f64, device=device) - cam["cx"]) / cam["fx"]
    ys = (torch.arange(h, dtype=f64, device=device) - cam["cy"]) / cam["fy"]
    dy, dx = torch.meshgrid(ys, xs, indexing="ij")
    dirs_cam = torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)
    c2w = torch.as_tensor(np.asarray(c2w, np.float64), device=device)
    R, o = c2w[:3, :3], c2w[:3, 3]
    dirs = dirs_cam @ R.T
    half = torch.as_tensor(np.asarray(half, np.float64), device=device)
    tbest = torch.full((h, w), math.inf, dtype=f64, device=device)
    wbest = torch.zeros((h, w), dtype=f64, device=device)
    for axis in range(3):
        for sgn in (-1.0, 1.0):
            d = dirs[..., axis]
            denom = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
            t = (sgn * half[axis] - o[axis]) / denom
            ok = t > 1e-6
            hit = o + t[..., None] * dirs
            for a2 in range(3):
                if a2 != axis:
                    ok = ok & (hit[..., a2].abs() <= half[a2] + 1e-6)
            better = ok & (t < tbest)
            tbest = torch.where(better, t, tbest)
            wbest = torch.where(better, torch.full_like(t, axis * 2 + (sgn > 0)),
                                wbest)
    hit = o + tbest[..., None] * dirs
    u = torch.zeros_like(tbest)
    v = torch.zeros_like(tbest)
    for wid in range(6):
        axis = wid // 2
        a, b = [x for x in range(3) if x != axis]
        m = wbest == wid
        u = torch.where(m, hit[..., a], u)
        v = torch.where(m, hit[..., b], v)
    ph = [float(x) for x in phases]
    color = torch.clamp(_texture(u, v, wbest, ph), 0.0, 1.0)
    depth = tbest * dirs_cam[..., 2]
    return color.float(), depth.float()


def quantize(color, depth, depth_scale: float) -> tuple:
    """What an RGB-D camera stores: uint8 colour, uint16 depth at
    ``depth_scale`` counts a metre (host numpy arrays)."""
    c8 = torch.round(torch.clamp(color * 255.0, 0.0, 255.0)).to(torch.uint8)
    d16 = torch.round(torch.clamp(depth.double() * depth_scale, 0.0, 65535.0))
    return c8.cpu().numpy(), d16.to(torch.int32).cpu().numpy().astype(np.uint16)


def motion_per_frame(poses: list) -> tuple:
    """(translations m, rotations deg) between consecutive poses."""
    tr, rot = [], []
    for a, b in zip(poses[:-1], poses[1:]):
        rel = np.linalg.inv(a) @ b
        tr.append(float(np.linalg.norm(b[:3, 3] - a[:3, 3])))
        c = (np.trace(rel[:3, :3]) - 1.0) / 2.0
        rot.append(math.degrees(math.acos(max(-1.0, min(1.0, c)))))
    return tr, rot
