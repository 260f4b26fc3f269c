"""Trajectory alignment + ATE metrics (the port's own copy of
gaus_slam_tpu/utils/trajectory.py, which replaces the evo dependency).

The reference computes APE translation RMSE after SE(3) Umeyama
alignment without scale (utils/eval.py:283-298 via evo). This is the
standard closed-form alignment.
"""
from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale=False):
    """Least-squares rigid alignment src -> dst. Points [N, 3]."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        c = np.trace(np.diag(D) @ S) / var_s
    else:
        c = 1.0
    t = mu_d - c * R @ mu_s
    return R, t, c


def ate_rmse(est_w2cs, gt_w2cs, align=True) -> dict:
    """ATE translation stats between estimated and gt w2c lists.

    NaN/inf gt poses are excluded (Backend.py:275-277 / eval.py:283-285).
    Returns dict with rmse/mean/median/std in the gt units (meters).
    """
    est_t, gt_t = [], []
    for e, g in zip(est_w2cs, gt_w2cs):
        g = np.asarray(g, np.float64)
        if not np.isfinite(g).all():
            continue
        e = np.asarray(e, np.float64)
        # camera centers: c2w translation
        est_t.append(np.linalg.inv(e)[:3, 3])
        gt_t.append(np.linalg.inv(g)[:3, 3])
    est_t = np.asarray(est_t)
    gt_t = np.asarray(gt_t)
    if align and len(est_t) >= 3:
        R, t, c = umeyama_alignment(est_t, gt_t)
        est_t = (c * (R @ est_t.T)).T + t
    err = np.linalg.norm(est_t - gt_t, axis=1)
    return {
        "rmse": float(np.sqrt((err**2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "max": float(err.max()),
        "min": float(err.min()),
    }
