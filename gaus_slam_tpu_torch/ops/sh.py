"""Spherical-harmonics <-> RGB helpers (port of gaus_slam_tpu/ops/sh.py;
reference utils/sh_utils.py).

The SLAM pipeline stores per-gaussian RGB directly (use_sh=False); these
conversions are kept for checkpoint interop with SH-based 3DGS tooling.
"""
C0 = 0.28209479177387814


def rgb_to_sh(rgb):
    return (rgb - 0.5) / C0


def sh_to_rgb(sh):
    return sh * C0 + 0.5
