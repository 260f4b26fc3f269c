"""Tracking / mapping losses on tile-major render buffers
(port of gaus_slam_tpu/slam/loss.py; reference slam/Loss.py:6-64).

Masks and reductions run in the [num_tiles, C, P] layout the kernels
emit; tile padding pixels carry gt_depth == 0 and drop out through the
depth-validity test.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.consts import constant


class LossConfig(NamedTuple):
    use_weight_norm: bool = True
    eps: float = 1e-6
    depth_far: float = 1e2
    depth_near: float = 1e-2
    enable_exposure: bool = False
    silmask_th: float = 0.90
    ignore_outliers: bool = False
    w_color_tracking: float = 0.5
    w_depth_tracking: float = 1.0
    w_color_mapping: float = 0.5
    w_depth_mapping: float = 1.0
    w_dist: float = 0.1
    use_edge_growth: bool = False
    edge_thres: float = 0.4


def normalized_depth(out_tiled: torch.Tensor, cfg: LossConfig) -> torch.Tensor:
    """render_depth / (alpha + eps) with far/near outliers zeroed."""
    depth = out_tiled[:, 3]
    alpha = out_tiled[:, 4]
    if cfg.use_weight_norm:
        depth = depth / (alpha + cfg.eps)
        bad = (depth > cfg.depth_far) | (depth < cfg.depth_near)
        depth = torch.where(bad, torch.zeros_like(depth), depth)
    return depth


def apply_exposure(color: torch.Tensor, exposure) -> torch.Tensor:
    if exposure is None:
        return color
    return exposure.gain * color + exposure.bias


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    big = constant(3.4e38, x.dtype, x.device)
    v = torch.sort(torch.where(mask, x, big).reshape(-1)).values
    n = torch.sum(mask)
    # indexed on the device (indexing with a device scalar reads it)
    return v.index_select(0, torch.clamp(n // 2, min=0).reshape(1))[0]


def tracking_loss(out_tiled, gt_tiled, cfg: LossConfig, exposure=None):
    """Masked sum-reduced L1 color+depth. gt_tiled: [T, 4, P] rows
    (r, g, b, depth). Returns (loss, aux)."""
    color = apply_exposure(out_tiled[:, 0:3], exposure)
    depth = normalized_depth(out_tiled, cfg)
    alpha = out_tiled[:, 4]
    gt_color = gt_tiled[:, 0:3]
    gt_depth = gt_tiled[:, 3]

    depth_mask = (gt_depth > 1e-5) & (depth > 1e-5)
    derr = torch.abs(depth - gt_depth)
    if cfg.ignore_outliers:
        med = _masked_median(derr * depth_mask, depth_mask)
        depth_mask = depth_mask & (derr < 10.0 * med)
    mask = depth_mask & (alpha > cfg.silmask_th)
    mf = mask.float()

    l_color = torch.sum(torch.abs(color - gt_color) * mf[:, None, :])
    l_depth = torch.sum(derr * mf)
    loss = cfg.w_color_tracking * l_color + cfg.w_depth_tracking * l_depth

    m2 = ((alpha > 0.9) & (gt_depth > 1e-4)).float()
    depth_l1 = torch.sum(derr * m2) / torch.clamp(torch.sum(m2), min=1.0)
    return loss, {"depth_l1": depth_l1, "n_masked": torch.sum(mf)}


def mapping_loss(out_tiled, gt_tiled, cfg: LossConfig, exposure=None):
    """Masked mean-reduced L1 color+depth + distortion."""
    color = apply_exposure(out_tiled[:, 0:3], exposure)
    depth = normalized_depth(out_tiled, cfg)
    alpha = out_tiled[:, 4]
    dist = out_tiled[:, 9]
    gt_color = gt_tiled[:, 0:3]
    gt_depth = gt_tiled[:, 3]

    depth_mask = ((gt_depth > 1e-5) & (depth > 1e-5)).float()
    if cfg.use_edge_growth:
        color_mask = (alpha > cfg.edge_thres).float()
    else:
        color_mask = depth_mask

    nc = torch.clamp(torch.sum(color_mask) * 3.0, min=1.0)
    nd = torch.clamp(torch.sum(depth_mask), min=1.0)
    l_color = torch.sum(torch.abs(color - gt_color) * color_mask[:, None, :]) / nc
    l_depth = torch.sum(torch.abs(depth - gt_depth) * depth_mask) / nd
    l_dist = torch.sum(dist * color_mask) / torch.clamp(torch.sum(color_mask),
                                                        min=1.0)
    loss = (cfg.w_color_mapping * l_color + cfg.w_depth_mapping * l_depth
            + cfg.w_dist * l_dist)
    return loss, {"l_color": l_color, "l_depth": l_depth, "l_dist": l_dist}
