"""Final evaluation pass (port of gaus_slam_tpu/utils/eval.py; reference
utils/eval.py:254-485).

Per frame, one captured program (``_eval_frame``): render at the
estimated pose (render_view, K3 on the card), PSNR on valid-depth
pixels, MS-SSIM, depth RMSE / L1; then LPIPS on the program's image (NaN
without local weights). Trajectory ATE-RMSE after Umeyama alignment. Writes
result.json and the per-frame .txt dumps with the JAX package's keys.
Under ``eval.eval_mesh`` the renders are TSDF-fused into a mesh and
scored (F-score, precision, recall) by utils/eval_mesh.py, which writes
reconstruction_metrics.json.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..models import gaussians as G
from ..ops.composite_ref import tiles_to_image
from ..render import capturable, render_view
from ..slam import programs
from ..slam.loss import normalized_depth
from ..utils.config import SystemConfig
from .image_metrics import lpips, lpips_available, ms_ssim, psnr
from .trajectory import ate_rmse


def _eval_frame(gm, w2c, gt_color, gt_depth, cam_proj, opts, lcfg,
                owner=None):
    """One frame's render and metrics, as one [4] device vector (PSNR,
    MS-SSIM, depth RMSE, depth L1: the caller's copy), and the clamped
    [H, W, 3] render (valid until the owner's next call). One captured
    program of ``owner`` (slam/programs.py), as the JAX package jits it:
    the render (K3), the image, PSNR, MS-SSIM and the depth metrics."""
    return programs.call(
        owner, "eval_frame", _eval_frame_body,
        dict(gm=gm, w2c=w2c, gt_color=gt_color, gt_depth=gt_depth,
             cam_proj=cam_proj), dict(opts=opts, lcfg=lcfg),
        outs=("vals", "rgb"), copies=("vals",), capture=capturable(opts),
        borrow=("gm",))


@torch.no_grad()
def _eval_frame_body(gm, w2c, gt_color, gt_depth, cam_proj, *, opts, lcfg):
    out = render_view(gm, cam_proj.replace_w2c(w2c), opts)
    img = tiles_to_image(
        torch.cat([out[:, 0:3], normalized_depth(out, lcfg)[:, None]], dim=1),
        opts.grid, cam_proj.height, cam_proj.width)
    rgb = torch.clamp(img[:3].permute(1, 2, 0), 0.0, 1.0)
    valid = gt_depth > 0
    diff = torch.where(valid, img[3] - gt_depth, torch.zeros_like(gt_depth))
    nv = torch.clamp(torch.sum(valid), min=1)
    return torch.stack([
        psnr(rgb, gt_color, mask=valid), ms_ssim(rgb, gt_color),
        torch.sqrt(torch.sum(diff**2) / nv),
        torch.sum(torch.abs(diff)) / nv]), rgb


def eval_final(config: dict, gm: G.GaussianMap, w2cs, gt_w2cs, dataset,
               out_dir: str | None = None, backend: str = "pallas",
               stride: int = 1, save_renders: bool = False,
               device="cuda") -> dict:
    """``dataset`` is indexable -> (color 0..255, depth, K, c2w)."""
    device = torch.device(device)
    sys_cfg = SystemConfig.from_config(config, backend=backend, device=device)
    cam, opts, lcfg = sys_cfg.cam, sys_cfg.opts, sys_cfg.lcfg
    out_dir = out_dir or config.get("vis_base_dir", "output")
    os.makedirs(out_dir, exist_ok=True)

    ate = ate_rmse(w2cs, gt_w2cs)
    want_img = bool(save_renders) or lpips_available()
    vals, lpipss = [], []
    # the frame's program and its buffers, for this call
    owner = programs.Owner("eval")
    n = min(len(w2cs), len(dataset))
    for i in range(0, n, stride):
        color, depth, _, _ = dataset[i]
        gt_np = np.asarray(color, np.float32) / 255.0
        gt_depth = np.asarray(depth, np.float32)
        if gt_depth.ndim == 3:
            gt_depth = gt_depth[..., 0]
        gt_color = torch.as_tensor(gt_np, device=device)
        v, rgb = _eval_frame(
            gm, torch.as_tensor(np.asarray(w2cs[i]), dtype=torch.float32,
                                device=device),
            gt_color, torch.as_tensor(gt_depth, device=device), cam, opts,
            lcfg, owner=owner)
        vals.append(v)
        if want_img:
            lpipss.append(lpips(rgb, gt_color))
            if save_renders:
                rd = os.path.join(out_dir, "renders")
                os.makedirs(rd, exist_ok=True)
                np.save(os.path.join(rd, f"{i:05d}.npy"), rgb.cpu().numpy())
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
    if config.get("eval", {}).get("eval_mesh", False):
        # TSDF-fuse the renders, score vs the gt mesh / unseen pointcloud
        # assets (or the depth-unprojection fallback) and emit
        # reconstruction_metrics.json (reference utils/eval.py:337-399,
        # 458-481 + eval_mesh.py:259-291)
        from .eval_mesh import evaluate_reconstruction, load_gt_mesh_assets

        ecfg = config["eval"]
        try:
            gt_mesh, unseen_pc, gt_points = load_gt_mesh_assets(
                config, dataset)
            mesh_metrics = evaluate_reconstruction(
                config, gm, w2cs, gt_points, out_dir=out_dir,
                backend=backend,
                mesh_interval=int(ecfg.get("mesh_interval", 5)),
                voxel_size=float(ecfg.get("voxel_size", 0.01)),
                gt_mesh=gt_mesh, unseen_pc=unseen_pc, device=device,
            )
            result["Mesh F-score"] = mesh_metrics.get("fscore")
            result["Mesh precision"] = mesh_metrics.get("precision")
            result["Mesh recall"] = mesh_metrics.get("recall")
        except Exception as e:  # noqa: BLE001 (ref wraps mesh eval in try)
            print(f"mesh evaluation failed: {e}")

    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=2)
    for name, vs in (("psnr", psnrs), ("ssim", ssims), ("lpips", lpipss),
                     ("rmse", rmses), ("l1", l1s)):
        with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
            f.write("\n".join(str(v) for v in vs))
    return result
