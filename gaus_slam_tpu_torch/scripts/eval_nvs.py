"""Novel-view-synthesis evaluation on held-out frames (port of
scripts/eval_nvs.py; reference scripts/eval_nvs.py + utils/eval.py:120-251).

    python -m gaus_slam_tpu_torch.scripts.eval_nvs <scene_dir> \
        [--backend pallas|interpret|reference] [--device cuda|cpu] \
        [--no_pose_refine]

Loads the saved scene and its dataset (the ``test`` split for ScanNet++).
Each frame's pose (the dataset's) is first refined by 100 tracking
iterations against the frozen map (``--no_pose_refine`` skips it), then
rendered and scored: PSNR on valid-depth pixels, MS-SSIM, LPIPS (NaN
without local weights) and depth L1. Writes nvs_result.json into
<scene_dir> with the JAX package's keys. ``evaluate`` is the same run
with its options as arguments, and ``frames=`` scores a subset of the
frames.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene_dir")
    ap.add_argument("--backend", default="pallas",
                    choices=("pallas", "interpret", "reference"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--no_pose_refine", action="store_true")
    args = ap.parse_args(argv)
    return evaluate(args.scene_dir, backend=args.backend, device=args.device,
                    pose_refine=not args.no_pose_refine)


def evaluate(scene_dir, *, backend="pallas", device="cuda", pose_refine=True,
             frames=None) -> dict:
    """The run of ``main``; ``frames``: the indices to score (default all
    of the split's frames)."""
    from ..data import get_dataset
    from ..models.frame import LrSchedule, init_pose
    from ..ops.composite_ref import image_to_tiles, tiles_to_image
    from ..render import bin_for_tracking, render_view
    from ..slam.loss import normalized_depth
    from ..slam.steps import TrackConfig, tracking_loop
    from ..utils.config import SystemConfig
    from ..utils.image_metrics import lpips, ms_ssim, psnr
    from ..utils.scene_io import load_scene

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the "
                           "CPU")
    dev = torch.device(device)
    config, gm, _, _ = load_scene(scene_dir, device=dev)
    data_cfg = dict(config["data"])
    if data_cfg["dataset_name"].lower() == "scannetpp":
        data_cfg["split"] = "test"
    dataset = get_dataset(data_cfg)
    sys_cfg = SystemConfig.from_config(config, backend=backend,
                                       device=dev)
    cam, opts, lcfg = sys_cfg.cam, sys_cfg.opts, sys_cfg.lcfg

    tcfg = TrackConfig(
        num_iters=100, converged_th=-1.0,
        rot_sched=LrSchedule(4e-4, 4e-5, 100),
        trans_sched=LrSchedule(2e-3, 2e-4, 100),
    )

    psnrs, ssims, lpipss, l1s = [], [], [], []
    for i in (range(len(dataset)) if frames is None else frames):
        color, depth, _, c2w = dataset[i]
        gt_color = torch.as_tensor(np.asarray(color, np.float32),
                                   device=dev) / 255.0
        gt_depth = torch.as_tensor(
            np.asarray(depth, np.float32).squeeze(), device=dev)
        w2c = torch.as_tensor(np.linalg.inv(c2w), dtype=torch.float32,
                              device=dev)

        if pose_refine:
            pose = init_pose(w2c, device=dev)
            cache = bin_for_tracking(gm, cam.replace_w2c(w2c), opts)
            gt = image_to_tiles(torch.cat([gt_color.permute(2, 0, 1),
                                           gt_depth[None]], 0), opts.grid)
            pose, _ = tracking_loop(cache, pose, gt, cam, opts, tcfg, lcfg)
            w2c = pose.w2c.detach()

        with torch.no_grad():
            out = render_view(gm, cam.replace_w2c(w2c), opts)
            img = tiles_to_image(
                torch.cat([out[:, 0:3],
                           normalized_depth(out, lcfg)[:, None]], 1),
                opts.grid, cam.height, cam.width)
            rgb = torch.clamp(img[:3].permute(1, 2, 0), 0, 1)
            valid = gt_depth > 0
            psnrs.append(float(psnr(rgb, gt_color, mask=valid)))
            ssims.append(float(ms_ssim(rgb, gt_color)))
            lpipss.append(lpips(rgb, gt_color))
            diff = torch.where(valid, img[3] - gt_depth,
                               torch.zeros_like(gt_depth))
            l1s.append(float(torch.abs(diff).sum()
                             / max(int(valid.sum()), 1)))

    result = {
        "NVS PSNR": float(np.mean(psnrs)),
        "NVS MS-SSIM": float(np.mean(ssims)),
        "NVS LPIPS": float(np.nanmean(lpipss)) if np.isfinite(lpipss).any()
        else float("nan"),
        "NVS Depth L1": float(np.mean(l1s)),
        "num_views": len(psnrs),
    }
    with open(os.path.join(scene_dir, "nvs_result.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(result)
    return result


if __name__ == "__main__":
    main()
