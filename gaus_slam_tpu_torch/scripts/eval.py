"""Re-evaluate a saved scene (port of scripts/eval.py).

    python -m gaus_slam_tpu_torch.scripts.eval <scene_dir> \
        [--backend pallas|interpret|reference] [--device cuda|cpu] \
        [--eval_mesh]

Loads the scene (config.json, gaussians.ply, w2cs) that the driver saved,
reads its dataset again, runs ``eval_final`` (result.json into
<scene_dir>) and, with ``--eval_mesh``, the mesh evaluation
(reconstruction_metrics.json).
"""
from __future__ import annotations

import argparse

import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene_dir",
                    help="directory with config.json + gaussians.ply")
    ap.add_argument("--backend", default="pallas",
                    choices=("pallas", "interpret", "reference"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--eval_mesh", action="store_true")
    args = ap.parse_args(argv)

    from ..data import get_dataset
    from ..utils.eval import eval_final
    from ..utils.scene_io import load_scene

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the "
                           "CPU")
    config, gm, w2cs, gt_w2cs = load_scene(args.scene_dir, device=args.device)
    dataset = get_dataset(config["data"])
    result = eval_final(config, gm, list(w2cs), list(gt_w2cs), dataset,
                        out_dir=args.scene_dir, backend=args.backend,
                        device=args.device)
    print(result)

    if args.eval_mesh:
        from ..utils.eval_mesh import (evaluate_reconstruction,
                                       load_gt_mesh_assets)

        gt_mesh, unseen_pc, gt_points = load_gt_mesh_assets(config, dataset)
        metrics = evaluate_reconstruction(
            config, gm, list(w2cs), gt_points, out_dir=args.scene_dir,
            backend=args.backend,
            mesh_interval=config.get("eval", {}).get("mesh_interval", 5),
            voxel_size=config.get("eval", {}).get("voxel_size", 0.01),
            gt_mesh=gt_mesh, unseen_pc=unseen_pc, device=args.device,
        )
        print(metrics)
        result = dict(result, mesh=metrics)
    return result


if __name__ == "__main__":
    main()
