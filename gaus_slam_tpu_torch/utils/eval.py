"""Final evaluation pass (port of gaus_slam_tpu/utils/eval.py; reference
utils/eval.py:254-485).

Per frame: render at the estimated pose (render_view, K3 on the card),
PSNR on valid-depth pixels, MS-SSIM, LPIPS (NaN without local weights),
depth RMSE / L1; trajectory ATE-RMSE after Umeyama alignment. Writes
result.json and the per-frame .txt dumps with the JAX package's keys.
The TSDF mesh evaluation (``eval.eval_mesh``) is not ported yet.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..models import gaussians as G
from ..ops.composite_ref import tiles_to_image
from ..render import render_view
from ..slam.loss import normalized_depth
from ..utils.config import SystemConfig
from .image_metrics import lpips, lpips_available, ms_ssim, psnr
from .trajectory import ate_rmse


@torch.no_grad()
def _eval_frame(gm, w2c, gt_color, gt_depth, cam_proj, opts, lcfg):
    """One frame's render and metrics, as device scalars, and the
    clamped [H, W, 3] render."""
    out = render_view(gm, cam_proj.replace_w2c(w2c), opts)
    img = tiles_to_image(
        torch.cat([out[:, 0:3], normalized_depth(out, lcfg)[:, None]], dim=1),
        opts.grid, cam_proj.height, cam_proj.width)
    rgb = torch.clamp(img[:3].permute(1, 2, 0), 0.0, 1.0)
    valid = gt_depth > 0
    diff = torch.where(valid, img[3] - gt_depth, torch.zeros_like(gt_depth))
    nv = torch.clamp(torch.sum(valid), min=1)
    return (psnr(rgb, gt_color, mask=valid), ms_ssim(rgb, gt_color),
            torch.sqrt(torch.sum(diff**2) / nv), torch.sum(torch.abs(diff)) / nv,
            rgb)


def eval_final(config: dict, gm: G.GaussianMap, w2cs, gt_w2cs, dataset,
               out_dir: str | None = None, backend: str = "pallas",
               stride: int = 1, save_renders: bool = False,
               device="cuda") -> dict:
    """``dataset`` is indexable -> (color 0..255, depth, K, c2w)."""
    if config.get("eval", {}).get("eval_mesh", False):
        raise NotImplementedError(
            "eval.eval_mesh: the TSDF mesh evaluation waits for ROADMAP "
            "queue 1 item 2 (eval and artifacts: utils/eval_mesh.py)")
    device = torch.device(device)
    sys_cfg = SystemConfig.from_config(config, backend=backend, device=device)
    cam, opts, lcfg = sys_cfg.cam, sys_cfg.opts, sys_cfg.lcfg
    out_dir = out_dir or config.get("vis_base_dir", "output")
    os.makedirs(out_dir, exist_ok=True)

    ate = ate_rmse(w2cs, gt_w2cs)
    want_img = bool(save_renders) or lpips_available()
    vals, lpipss = [], []
    n = min(len(w2cs), len(dataset))
    for i in range(0, n, stride):
        color, depth, _, _ = dataset[i]
        gt_np = np.asarray(color, np.float32) / 255.0
        gt_depth = np.asarray(depth, np.float32)
        if gt_depth.ndim == 3:
            gt_depth = gt_depth[..., 0]
        *scalars, rgb = _eval_frame(
            gm, torch.as_tensor(np.asarray(w2cs[i]), dtype=torch.float32,
                                device=device),
            torch.as_tensor(gt_np, device=device),
            torch.as_tensor(gt_depth, device=device), cam, opts, lcfg)
        vals.append(torch.stack(scalars))
        if want_img:
            rgb_np = rgb.cpu().numpy()
            lpipss.append(lpips(rgb_np, gt_np))
            if save_renders:
                rd = os.path.join(out_dir, "renders")
                os.makedirs(rd, exist_ok=True)
                np.save(os.path.join(rd, f"{i:05d}.npy"), rgb_np)
        else:
            lpipss.append(float("nan"))
    # one readback for every frame's metrics
    psnrs, ssims, rmses, l1s = (
        [float(v) for v in col]
        for col in torch.stack(vals).double().cpu().numpy().T)

    finite_lpips = [v for v in lpipss if np.isfinite(v)]
    result = {
        "PSNR": float(np.mean(psnrs)),
        "MS-SSIM": float(np.mean(ssims)),
        "LPIPS": float(np.mean(finite_lpips)) if finite_lpips
        else float("nan"),
        **({} if finite_lpips else {
            "lpips_note": "no weights found; export with "
            "tools/export_lpips_weights.py and set $LPIPS_WEIGHTS"}),
        "Depth RMSE": float(np.mean(rmses)),
        "Depth L1": float(np.mean(l1s)),
        "ATE RMSE": ate["rmse"],
        "ATE stats": ate,
        "num_gaussians": int(gm.n_active),
    }
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=2)
    for name, vs in (("psnr", psnrs), ("ssim", ssims), ("lpips", lpipss),
                     ("rmse", rmses), ("l1", l1s)):
        with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
            f.write("\n".join(str(v) for v in vs))
    return result
