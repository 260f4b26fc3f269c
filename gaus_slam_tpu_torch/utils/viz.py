"""Headless dashboards and the video writer (port of
gaus_slam_tpu/utils/viz.py): the pngs the reference writes per submap
(frontend_numpts, depth_l1, backend_numpts, ape, trackloss, and the
evo_2dplot trajectory plot), and ``frames_to_video``.

matplotlib is imported when a plot is drawn, never at import: a machine
without it can run everything but the dashboards, and a dashboard asked
for there raises ImportError.
"""
from __future__ import annotations

import os

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_series(values, path, title=None):
    plt = _plt()
    plt.figure(figsize=(6, 3))
    plt.plot(range(len(values)), values)
    if title:
        plt.title(title)
    plt.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path, dpi=90)
    plt.close()


def save_trajectory_plot(est_w2cs, gt_w2cs, path, ate=None):
    """Top-down (x, z) trajectory comparison, the evo_2dplot analogue
    (Backend.update_common_visualization, Backend.py:271-311)."""
    plt = _plt()
    est = np.array([np.linalg.inv(np.asarray(m))[:3, 3] for m in est_w2cs])
    gt = np.array([np.linalg.inv(np.asarray(m))[:3, 3] for m in gt_w2cs])
    plt.figure(figsize=(5, 5))
    plt.plot(gt[:, 0], gt[:, 2], "--", color="gray", label="gt")
    err = np.linalg.norm(est - gt, axis=1)
    sc = plt.scatter(est[:, 0], est[:, 2], c=err, cmap="jet", s=4,
                     label="est")
    plt.colorbar(sc, label="APE [m]")
    if ate is not None:
        plt.title(f"ATE RMSE: {ate:.4f} m")
    plt.legend()
    plt.axis("equal")
    plt.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path, dpi=90)
    plt.close()


def frames_to_video(frames, path, fps=30):
    """Stack of [H, W, 3] float 0..1 frames -> the video written, as a
    path: mp4 through imageio where it imports (its .gif beside ``path``
    if the mp4 writer fails, as the JAX package does), else
    ``<stem>.gif`` from the port's own encoder (utils/gif.py: a fixed
    palette and LZW), as on a machine without imageio or cv2."""
    arr = [np.clip(np.asarray(f) * 255, 0, 255).astype(np.uint8)
           for f in frames]
    gif_path = os.path.splitext(path)[0] + ".gif"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import imageio.v2 as imageio
    except ImportError:
        from .gif import write_gif

        write_gif(gif_path, arr, fps=fps)
        return gif_path
    try:
        imageio.mimwrite(path, arr, fps=fps)
        return path
    except Exception:  # noqa: BLE001 (no mp4 plugin: the JAX fallback)
        imageio.mimwrite(gif_path, arr, fps=fps)
        return gif_path
