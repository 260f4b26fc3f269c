"""Scene checkpoint save / load (port of gaus_slam_tpu/utils/scene_io.py;
reference scene/__init__.py:9-45).

Artifacts: config.json + gaussians.ply + w2cs.npz.npy + gt_w2cs.npz.npy,
the format the eval / NVS / video / viewer entry points read; a scene
written by either package loads in the other.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..models import gaussians as G
from .ply import read_gaussians_ply, write_gaussians_ply


def save_scene(config: dict, gm: G.GaussianMap, w2cs, gt_w2cs, path: str):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, default=lambda o: None)
    n = int(gm.n_active)
    write_gaussians_ply(os.path.join(path, "gaussians.ply"),
                        *(p[:n].detach().cpu().numpy() for p in gm.params))
    np.save(os.path.join(path, "w2cs.npz"), np.stack(w2cs))
    np.save(os.path.join(path, "gt_w2cs.npz"), np.stack(gt_w2cs))


def load_scene(path: str, quantum: int = 1 << 16, device="cuda"):
    """(config, map on ``device``, w2cs, gt_w2cs) of a saved scene."""
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    raw = read_gaussians_ply(os.path.join(path, "gaussians.ply"))
    n = raw["xyz"].shape[0]
    cap = max(quantum, -(-int(n * 1.1) // quantum) * quantum)
    gm = G.empty_map(cap, device)
    params = G.Params(*(p.clone() for p in gm.params))
    for f, p in zip(G.PARAM_FIELDS, params):
        p[:n] = torch.as_tensor(raw[f], dtype=torch.float32, device=device)
    gm = gm._replace(params=params,
                     active=torch.arange(cap, device=device) < n,
                     n_active=torch.tensor(n, dtype=torch.int32, device=device))
    w2cs = np.load(os.path.join(path, "w2cs.npz.npy"))
    gt_w2cs = np.load(os.path.join(path, "gt_w2cs.npz.npy"))
    return config, gm, w2cs, gt_w2cs
