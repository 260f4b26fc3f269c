"""Image quality metrics on tensors: PSNR, SSIM, MS-SSIM, and the LPIPS
hook (port of gaus_slam_tpu/utils/image_metrics.py).

The reference evaluates PSNR on valid-depth-masked pixels, MS-SSIM as
pytorch_msssim does and LPIPS(alex) (utils/eval.py:401-423). SSIM's 11x11
gaussian window is a depthwise ``F.conv2d``, run without TF32 so that the
card computes it in float32 as the CPU does. LPIPS needs pretrained
AlexNet weights from $LPIPS_WEIGHTS (utils/lpips.py): without them
``lpips`` returns NaN, as the JAX package does.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.consts import cached, constant


def psnr(img: torch.Tensor, ref: torch.Tensor, mask=None) -> torch.Tensor:
    """PSNR over (optionally masked) pixels; images [..., 3] in 0..1."""
    se = (img - ref) ** 2
    if mask is not None:
        mf = mask.float()[..., None]
        mse = torch.sum(se * mf) / torch.clamp(torch.sum(mf) * 3, min=1.0)
    else:
        mse = torch.mean(se)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def _gaussian_window(device, size=11, sigma=1.5) -> torch.Tensor:
    """The [size, size] float32 window, made once per device (a captured
    program reads it: ops/consts.py)."""
    def make():
        x = np.arange(size) - size // 2
        g = np.exp(-(x**2) / (2 * sigma**2))
        g /= g.sum()
        return np.outer(g, g).astype(np.float32)

    return cached(("ssim_window", size, sigma), make, device)


def _filter2d(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Depthwise 'valid' correlation of [H, W, C] with a [k, k] window."""
    cudnn = torch.backends.cudnn
    tf32, cudnn.allow_tf32 = cudnn.allow_tf32, False
    try:
        out = F.conv2d(img.permute(2, 0, 1)[:, None], win[None, None])
    finally:
        cudnn.allow_tf32 = tf32
    return out[:, 0].permute(1, 2, 0)


def ssim_parts(x, y, win, c1=0.01**2, c2=0.03**2):
    mx = _filter2d(x, win)
    my = _filter2d(y, win)
    mxx = _filter2d(x * x, win) - mx * mx
    myy = _filter2d(y * y, win) - my * my
    mxy = _filter2d(x * y, win) - mx * my
    cs = (2 * mxy + c2) / (mxx + myy + c2)
    lum = (2 * mx * my + c1) / (mx * mx + my * my + c1)
    return lum.mean(), cs.mean()


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    lum, cs = ssim_parts(x, y, _gaussian_window(x.device))
    return lum * cs


MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _downsample2(img):
    h, w, c = img.shape
    img = img[: h // 2 * 2, : w // 2 * 2]
    return img.reshape(h // 2, 2, w // 2, 2, c).mean(dim=(1, 3))


def ms_ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Multi-scale SSIM (pytorch_msssim convention); the level count
    shrinks for small images so the 11x11 window always fits."""
    levels = 5
    while levels > 1 and min(x.shape[0], x.shape[1]) < 11 * 2 ** (levels - 1):
        levels -= 1
    win = _gaussian_window(x.device)
    weights = constant(MS_WEIGHTS[:levels], torch.float32, x.device)
    weights = weights / torch.sum(weights)
    vals = []
    for lvl in range(levels):
        lum, cs = ssim_parts(x, y, win)
        vals.append(torch.clamp(lum if lvl == levels - 1 else cs, min=0.0))
        if lvl < levels - 1:
            x = _downsample2(x)
            y = _downsample2(y)
    return torch.prod(torch.stack(vals) ** weights)


@functools.lru_cache(maxsize=4)
def _lpips_model(path: str, device: str):
    from .lpips import load_lpips

    return load_lpips(path, device)


def lpips_available() -> bool:
    """True when $LPIPS_WEIGHTS names a file."""
    path = os.environ.get("LPIPS_WEIGHTS", "")
    return bool(path) and os.path.exists(path)


def lpips(x, y) -> float:
    """LPIPS(alex) of two [H, W, 3] images in 0..1, on the device of ``x``
    (the CPU for numpy); NaN when pretrained weights are unavailable."""
    device = x.device if isinstance(x, torch.Tensor) else torch.device("cpu")
    model = _lpips_model(os.environ.get("LPIPS_WEIGHTS", ""), str(device))
    if model is None:
        return float("nan")
    return float(model(x, y))
