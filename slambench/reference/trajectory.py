"""Camera-centre errors of an estimated trajectory against the true one,
after the least-squares rigid (Umeyama, no scale) alignment of the whole
trajectory: a frozen copy of the port's ``utils/trajectory.py`` math,
returning every frame's error."""
from __future__ import annotations

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray):
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, _, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    return R, mu_d - R @ mu_s


def centre_errors(est_w2cs, gt_c2ws) -> np.ndarray:
    """Per-frame distance (m) between the aligned estimated camera centre
    and the true one."""
    est = np.asarray([np.linalg.inv(np.asarray(e, np.float64))[:3, 3]
                      for e in est_w2cs])
    gt = np.asarray([np.asarray(g, np.float64)[:3, 3] for g in gt_c2ws])
    if len(est) >= 3:
        R, t = umeyama(est, gt)
        est = est @ R.T + t
    return np.linalg.norm(est - gt, axis=1)
