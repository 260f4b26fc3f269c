"""Single-process SLAM driver of the port (port of scripts/gaus.py;
reference scripts/gaus.py).

    python -m gaus_slam_tpu_torch.scripts.gaus <config.py> \
        [--backend pallas|interpret|reference] [--device cuda|cpu] \
        [--resume <vis_base_dir>/ckpt]

Loads the experiment config module, streams the dataset through the
Frontend, drains every cut submap into the Backend at once, runs the
final refinement and the evaluation, and saves the scene. Under
``backend.save_ckpt`` a checkpoint is written to <vis_base_dir>/ckpt at
every submap boundary; ``--resume`` restores one and continues from the
frame after it. On a host with more than one card ``tpu.mesh_devices``
shards the backend's BA over a group of them (parallel/). The calls and
their order are those of scripts/gaus.py, except that the frontend's
dashboards are drawn only under backend.common_vis, as the backend's are
(matplotlib, which draws them, may be missing on the card's machine).
"""
from __future__ import annotations

import argparse
import json
import os
import queue
import random
import time

import numpy as np
import torch


def seed_everything(seed: int):
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def make_wandb_run(config: dict):
    """wandb init (reference scripts/gaus.py:31-43); None when disabled or
    the package is unavailable."""
    if not config.get("use_wandb", False):
        return None
    try:
        import wandb

        wcfg = config.get("wandb", {})
        return wandb.init(project=wcfg.get("project_name", "gaus_slam_tpu"),
                          name=wcfg.get("name"), config=config)
    except Exception as e:  # noqa: BLE001
        print(f"wandb disabled ({e})")
        return None


def start_run(config: dict, backend: str, device, resume_from):
    """What both drivers set up before their frame loop: the seeds, the
    dataset and its camera, the Frontend, the Backend (with its BA group
    on a host with more than one card: tpu.mesh_devices), and a restored
    checkpoint. Returns (device, dataset, num_frames, to_backend queue,
    frontend, backend, wandb run, first frame to process)."""
    from ..data import get_dataset
    from ..parallel import devices_from_config
    from ..slam.backend import Backend
    from ..slam.frontend import Frontend
    from ..utils.checkpoint import restore_run_state
    from ..utils.config import probe_cameras

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' (--device "
                               "cpu) to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    seed_everything(config.get("seed", 0))
    dataset = get_dataset(config["data"])
    num_frames = config["data"].get("num_frames", -1)
    if num_frames == -1:
        num_frames = len(dataset)

    color0, _, intrinsics, _ = dataset[0]
    probe_cameras(config, color0, intrinsics)

    wandb_run = make_wandb_run(config)
    to_backend = queue.Queue()
    frontend = Frontend(config, to_backend, wandb_run=wandb_run,
                        backend=backend, device=device)
    devices = devices_from_config(config, device)
    if devices is not None:
        print(f"[gaus] backend BA sharded over {len(devices)} devices")
    backend_ = Backend(config, wandb_run=wandb_run, backend=backend,
                       device=device, devices=devices)
    t0_frame = 0
    if resume_from is not None:
        t0_frame = restore_run_state(resume_from, frontend, backend_,
                                     dataset)
        print(f"resumed from {resume_from} at frame {t0_frame}")
    return (device, dataset, num_frames, to_backend, frontend, backend_,
            wandb_run, t0_frame)


def end_run(config: dict, frontend, backend_, dataset, wandb_run,
            backend: str, device) -> dict:
    """What both drivers do after the final refinement: time.json, the
    evaluation and the saved scene, which read the backend's map. A map
    on a card of the backend's own is evaluated on the frontend's, where
    the frames are."""
    from ..models import gaussians as G
    from ..utils.eval import eval_final
    from ..utils.scene_io import save_scene

    backend_.wait()
    frontend.write_time_json()
    out_dir = config.get("vis_base_dir", "output")
    w2cs = backend_.local_maps.get_w2cs()
    gt_w2cs = backend_.local_maps.get_gt_w2cs()
    gm = backend_.map
    if gm.params.xyz.device != device:
        gm = G.map_to(gm, device)
    result = eval_final(config, gm, w2cs, gt_w2cs, dataset,
                        out_dir=out_dir, backend=backend,
                        save_renders=config.get("eval", {}).get(
                            "save_renders", False), device=device)
    print(json.dumps(result, indent=2))
    save_scene(config, gm, w2cs, gt_w2cs,
               os.path.join(out_dir, "scene"))
    if wandb_run is not None:
        wandb_run.log(result)
        wandb_run.finish()
    return result


def rgbd_slam(config: dict, backend: str = "pallas", device="cuda",
              resume_from: str | None = None) -> dict:
    from ..utils.checkpoint import save_run_state

    (device, dataset, num_frames, to_backend, frontend, backend_, wandb_run,
     t0_frame) = start_run(config, backend, device, resume_from)
    out_dir = config.get("vis_base_dir", "output")
    common_vis = bool(config["backend"].get("common_vis", False))
    save_ckpt = bool(config["backend"].get("save_ckpt", False))

    t_start = time.perf_counter()
    for t in range(t0_frame, num_frames):
        color, depth, _, c2w = dataset[t]
        depth = np.asarray(depth)
        if depth.ndim == 3:
            depth = depth[..., 0]
        frontend.process_frame(
            t, np.asarray(color, np.float32) / np.float32(255), depth, c2w)
        submap_done = False
        while not to_backend.empty():
            backend_.process_localmap(to_backend.get(), multi_process=False)
            submap_done = True
        if submap_done:
            # per-submap dashboards + resumable checkpoint
            # (reference gaus.py:92-95 + Backend.py:271-331)
            backend_.update_common_visualization()
            if common_vis:
                frontend.update_common_visualization()
            if save_ckpt:
                save_run_state(os.path.join(out_dir, "ckpt"), frontend,
                               backend_, next_frame_idx=t + 1)
        if t % 25 == 0:
            backend_.wait()
            n_global = (int(backend_.map.n_active)
                        if backend_.map is not None else 0)
            print(f"frame {t}/{num_frames} "
                  f"pts={int(frontend.map.n_active)} global={n_global}")

    frontend.process_final()
    while not to_backend.empty():
        backend_.process_localmap(to_backend.get(), multi_process=False)
    backend_.final_refine(progress=True)
    frontend.total_time = time.perf_counter() - t_start
    return end_run(config, frontend, backend_, dataset, wandb_run, backend,
                   device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--backend", default="pallas",
                    choices=("pallas", "interpret", "reference"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--resume", default=None,
                    help="resume from a mid-run checkpoint dir")
    args = ap.parse_args(argv)

    from ..utils.config import load_config

    return rgbd_slam(load_config(args.config), backend=args.backend,
                     device=args.device, resume_from=args.resume)


if __name__ == "__main__":
    main()
