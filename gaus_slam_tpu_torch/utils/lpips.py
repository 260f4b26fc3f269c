"""LPIPS(alex) from a local weights file (port of
gaus_slam_tpu/utils/lpips_jax.py).

The reference uses the `lpips` pip package with downloaded AlexNet and
linear-head weights (utils/eval.py:300). Nothing is downloaded here:
LPIPS is NaN unless $LPIPS_WEIGHTS names an .npz with the AlexNet
convolutions ``conv{i}_w`` / ``conv{i}_b`` and the LPIPS linear heads
``lin{i}_w`` (the export schema of tools/export_lpips_weights.py).
The convolutions are ``F.conv2d`` run in float32 (no TF32), as the JAX
package computes them with ``lax.conv`` outside any Pallas kernel.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

ALEX_CFG = [
    # (out_ch, kernel, stride, padding)
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def load_lpips(path: str | None = None, device="cuda"):
    """A function (x, y) -> LPIPS distance (a 0-d tensor) of two [H, W, 3]
    images in 0..1 (numpy or tensors), with the weights on ``device``; None
    without a weights file."""
    path = path or os.environ.get("LPIPS_WEIGHTS", "")
    if not path or not os.path.exists(path):
        return None
    device = torch.device(device)
    with np.load(path) as f:
        w = {k: torch.as_tensor(np.asarray(f[k], np.float32), device=device)
             for k in f.files}
    shift = torch.tensor(SHIFT, device=device)
    scale = torch.tensor(SCALE, device=device)

    def feats(img):
        # NOTE: no [0,1] -> [-1,1] rescale. The reference feeds
        # clamp(img, 0, 1) into lpips with normalize=False
        # (utils/eval.py:409), so the scaling layer sees raw [0,1];
        # parity requires reproducing that quirk.
        h = (torch.as_tensor(img, dtype=torch.float32, device=device)
             - shift) / scale
        h = h.permute(2, 0, 1)[None]
        outs = []
        for i, (_, _, s, p) in enumerate(ALEX_CFG):
            h = F.relu(F.conv2d(h, w[f"conv{i}_w"], w[f"conv{i}_b"],
                                stride=s, padding=p))
            if i in (0, 1):
                h = F.max_pool2d(h, 3, stride=2)
            outs.append(h)
        return outs

    @torch.no_grad()
    def forward(x, y) -> torch.Tensor:
        cudnn = torch.backends.cudnn
        tf32, cudnn.allow_tf32 = cudnn.allow_tf32, False
        try:
            fx, fy = feats(x), feats(y)
        finally:
            cudnn.allow_tf32 = tf32
        total = torch.zeros((), device=device)
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / torch.clamp(torch.linalg.norm(a, dim=1, keepdim=True),
                                min=1e-10)
            b = b / torch.clamp(torch.linalg.norm(b, dim=1, keepdim=True),
                                min=1e-10)
            lin = w[f"lin{i}_w"].reshape(1, -1, 1, 1)
            total = total + ((a - b) ** 2 * lin).sum(dim=1).mean()
        return total

    return forward
