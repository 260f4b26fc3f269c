"""SplaTAM-style baseline without submaps (port of scripts/splatam.py;
reference scripts/splatam.py).

    python -m gaus_slam_tpu_torch.scripts.splatam <config.py> \
        [--backend pallas|interpret|reference] [--device cuda|cpu]

One global map for the whole run: each frame is tracked against it from
a constant-velocity init; keyframes (every ``splatam.keyframe_every``
frames, and frames whose descriptor is novel against the last 20
keyframes, similarity under ``splatam.desc_threshold``) densify the map
and run ``frontend.num_mapping_iters`` mapping steps over random
keyframes, then a prune. The map's capacity grows before every keyframe
densify, so no new gaussian is dropped. A final refinement over random
keyframes, the time.json contract, eval_final and save_scene follow,
under ``<vis_base_dir>_splatam``. The "no-localmap" comparison baseline
(reference README.md:163-168, ablation F); configs/replica/splatam.py
is its profile (3DGS, isotropic gaussians).
"""
from __future__ import annotations

import argparse
import json
import os
import random
import time

import numpy as np
import torch


def rgbd_slam(config: dict, backend: str = "pallas", device="cuda") -> dict:
    from ..data import get_dataset
    from ..models import gaussians as G
    from ..models.descriptor import describe_image
    from ..models.frame import init_exposure, init_pose
    from ..ops.composite_ref import image_to_tiles
    from ..render import bin_for_tracking, render_view
    from ..slam.densify import add_new_gaussians, prune_gaussians
    from ..slam.init_map import initialize_map
    from ..slam.steps import mapping_step, tracking_loop
    from ..utils.config import SystemConfig, probe_cameras
    from ..utils.eval import eval_final
    from ..utils.scene_io import save_scene
    from .gaus import seed_everything

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--device "
                           "cpu) to run on the CPU")
    seed_everything(config.get("seed", 0))
    dataset = get_dataset(config["data"])
    num_frames = config["data"].get("num_frames", -1)
    if num_frames == -1:
        num_frames = len(dataset)
    color0, _, intrinsics, _ = dataset[0]
    probe_cameras(config, color0, intrinsics)
    s = SystemConfig.from_config(config, backend=backend, device=device)

    # the keyframe draws of the mapping loop: the JAX driver's sequence
    rng = random.Random(config.get("seed", 0))
    kf_every = int(config.get("splatam", {}).get("keyframe_every", 8))
    desc_th = float(config.get("splatam", {}).get("desc_threshold", 0.8))
    tpu_cfg = config.get("tpu", {})
    quantum = int(tpu_cfg.get("capacity_quantum", 1 << 17))
    margin = float(tpu_cfg.get("capacity_margin", 1.3))
    cap_floor = int(tpu_cfg.get("backend_capacity", 0))
    n_map = int(config["frontend"]["num_mapping_iters"])

    def fit_capacity(gm, headroom=0):
        """Grow the single global map's capacity bucket so that a densify
        never runs out of rows."""
        n = int(gm.n_active) + headroom
        cap = G.bucket_capacity(n, quantum, margin, cap_floor)
        return G.resize_map(gm, cap) if cap > gm.capacity else gm

    def mapping(gm, exp):
        gt_i, w2c_i = kfs[rng.randrange(len(kfs))]
        gm, exp, _ = mapping_step(gm, w2c_i, gt_i, exp, False,
                                  s.exp_sched_front, s.cam, s.opts, s.mcfg,
                                  s.lcfg)
        return gm, exp

    kfs = []  # (gt_tiled, w2c) of every keyframe
    w2cs, gt_w2cs, descs = [], [], []
    gm = None
    vel = np.eye(4, dtype=np.float32)
    exp = init_exposure(device)
    t_track = [0.0, 0]
    t_map = [0.0, 0]
    t0 = time.perf_counter()

    for t in range(num_frames):
        color, depth, _, c2w = dataset[t]
        depth = np.asarray(depth).squeeze()
        gt_color = torch.as_tensor(
            (np.asarray(color) / 255.0).astype(np.float32), device=device)
        gt_depth = torch.as_tensor(depth.astype(np.float32), device=device)
        gt_w2c = np.linalg.inv(np.asarray(c2w))
        gt_tiled = image_to_tiles(
            torch.cat([gt_color.permute(2, 0, 1), gt_depth[None]], 0),
            s.opts.grid)

        if t == 0:
            cap = G.bucket_capacity(depth.size, quantum, margin, cap_floor)
            gm = initialize_map(cap, gt_color, gt_depth,
                                torch.eye(4, device=device), s.cam)
            w2c = np.eye(4, dtype=np.float32)
        else:
            tt0 = time.perf_counter()
            pose = init_pose(vel @ w2cs[-1], device)
            cache = bin_for_tracking(gm, s.cam.replace_w2c(pose.w2c), s.opts)
            pose, _ = tracking_loop(cache, pose, gt_tiled, s.cam, s.opts,
                                    s.track_front, s.lcfg)
            w2c = pose.w2c.detach().cpu().numpy()
            vel = w2c @ np.linalg.inv(w2cs[-1])
            t_track[0] += time.perf_counter() - tt0
            t_track[1] += 1

        w2cs.append(w2c)
        gt_w2cs.append(gt_w2c)
        d = describe_image(gt_color).cpu().numpy()
        is_kf = t == 0 or t % kf_every == 0
        if not is_kf and descs:
            sim = max(float(np.dot(d, q)) for q in descs[-20:])
            is_kf = sim < desc_th  # a novel view
        if is_kf:
            tm0 = time.perf_counter()
            descs.append(d)
            w2cj = torch.as_tensor(w2c, dtype=torch.float32, device=device)
            # a keyframe densify adds up to one gaussian per pixel: make
            # room before the add
            gm = fit_capacity(gm, headroom=depth.size)
            out = render_view(gm, s.cam.replace_w2c(w2cj), s.opts)
            gm = add_new_gaussians(gm, w2cj, gt_color, gt_depth, out,
                                   s.cam, s.opts, s.dcfg, s.lcfg)
            kfs.append((gt_tiled, w2cj))
            for _ in range(n_map):
                gm, exp = mapping(gm, exp)
            gm = prune_gaussians(gm, s.dcfg)
            t_map[0] += time.perf_counter() - tm0
            t_map[1] += n_map

    # final refinement over random keyframes (reference splatam.py:255-264)
    for _ in range(num_frames):
        gm, exp = mapping(gm, exp)

    total = time.perf_counter() - t0
    print(f"fps: {num_frames / total:.3f}")
    out_dir = config.get("vis_base_dir", "output") + "_splatam"
    os.makedirs(out_dir, exist_ok=True)
    # time.json contract (reference splatam.py:266-287)
    with open(os.path.join(out_dir, "time.json"), "w") as f:
        json.dump({
            "tracking_iter_time(ms)": t_track[0] / max(t_track[1], 1) * 1000,
            "tracking_frame_time(s)": t_track[0] / max(t_track[1], 1),
            "mapping_iter_time(ms)": t_map[0] / max(t_map[1], 1) * 1000,
            "mapping_frame_time(s)": t_map[0] / max(len(kfs), 1),
            "frame_time": total / num_frames,
        }, f)
    result = eval_final(config, gm, w2cs, gt_w2cs, dataset, out_dir=out_dir,
                        backend=backend, device=device)
    print(json.dumps(result, indent=2))
    # scene checkpoint contract (reference splatam.py:288-291)
    save_scene(config, gm, w2cs, gt_w2cs, os.path.join(out_dir, "scene"))
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--backend", default="pallas",
                    choices=("pallas", "interpret", "reference"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from ..utils.config import load_config

    return rgbd_slam(load_config(args.config), backend=args.backend,
                     device=args.device)


if __name__ == "__main__":
    main()
