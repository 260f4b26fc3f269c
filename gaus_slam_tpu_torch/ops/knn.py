"""Nearest-neighbour initial-scale estimation, the simple-knn replacement
(port of gaus_slam_tpu/ops/knn.py).

The reference's ``distCUDA2`` returns the mean squared distance to each
point's 3 nearest neighbours. The SLAM pipeline always passes a
depth-derived scale, so this is a compatibility path: a Morton-key
bucketing of the points and a scan of their sorted neighbourhood, all
vectorised.
"""
from __future__ import annotations

import torch


def _spread(x: torch.Tensor) -> torch.Tensor:
    """Interleave the low 10 bits of x with two zero bits each (Morton)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def mean_knn_sq_dist(points: torch.Tensor, k: int = 3,
                     window: int = 8) -> torch.Tensor:
    """Approximate mean squared distance to the k nearest neighbours.

    Points are sorted along a Morton key of 10 bits per axis; each
    point's candidates are its ``2 * window`` neighbours in that order
    (distCUDA2 itself searches a space-filling-curve neighbourhood)."""
    n = points.shape[0]
    dev = points.device
    lo = points.min(dim=0).values
    hi = points.max(dim=0).values
    ext = torch.clamp(hi - lo, min=1e-6)
    q = ((points - lo) / ext * 1023.0).to(torch.int32)
    key = _spread(q[:, 0]) | (_spread(q[:, 1]) << 1) | (_spread(q[:, 2]) << 2)
    order = torch.argsort(key, stable=True)
    p_sorted = points[order]

    idx = torch.arange(n, device=dev)
    inf = torch.full((n,), float("inf"), dtype=points.dtype, device=dev)
    dists = []
    for off in range(1, window + 1):
        for sgn in (-1, 1):
            shifted = torch.roll(p_sorted, sgn * off, dims=0)
            d2 = torch.sum((p_sorted - shifted) ** 2, dim=1)
            # wrapped-around neighbours are not neighbours
            ok = (idx + sgn * off >= 0) & (idx + sgn * off < n)
            dists.append(torch.where(ok, d2, inf))
    d = torch.stack(dists, dim=1)                       # [n, 2 * window]
    dk = torch.topk(d, k, dim=1, largest=False).values  # k smallest
    mean_sq = torch.mean(torch.where(torch.isfinite(dk), dk,
                                     torch.zeros_like(dk)), dim=1)
    out = torch.zeros((n,), dtype=points.dtype, device=dev)
    out[order] = mean_sq
    return torch.clamp(out, min=1e-7)
