"""One quality-A/B variant, all its seeds, in one process (port of
tools/ab_runner.py).

Sets the variant's env overrides and SYN_H / SYN_W / SYN_FRAMES, then for
each seed SEED and SYN_OUT, loads configs/synthetic/config.py afresh and
runs the port's driver (scripts/gaus.py ``rgbd_slam``). Prints one
``ABROW {json}`` line per seed with the JAX rows' keys (seed, variant,
wall_s, psnr, ate_rmse, ssim, depth_l1); a seed that raises gives a row
with ``error`` and the sweep goes on. The driver reseeds ``random``, numpy
and torch at its start and the config is read anew for each seed, so a
seed's row does not depend on the seeds run before it in the process.
Variants keep a process each (tools/quality_ab.py): their env knobs are
read when the config and the driver's modules load.

    python -m gaus_slam_tpu_torch.tools.ab_runner --variant default \
        --seeds 0 1 2 [--env '{"COARSE_ITERS": "0"}'] [--frames 100] \
        [--height 340] [--width 600] [--device cuda|cpu] [--out-root output]

On the card the driver runs the hand-written kernels ("pallas");
``--device cpu`` runs their plain versions ("interpret").
"""
from __future__ import annotations

import argparse
import json
import os
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG = os.path.join(ROOT, "configs", "synthetic", "config.py")


def run_seed(variant: str, seed: int, backend: str, device: str,
             out_root: str) -> dict:
    """One driver run of ``variant`` at ``seed`` under the env already
    set; returns its row."""
    from ..scripts.gaus import rgbd_slam
    from ..utils.config import load_config

    os.environ["SEED"] = str(seed)
    os.environ["SYN_OUT"] = os.path.join(out_root, f"ab_{variant}_s{seed}")
    t0 = time.time()
    try:
        res = rgbd_slam(load_config(CONFIG), backend=backend, device=device)
        return {
            "seed": seed, "variant": variant,
            "wall_s": round(time.time() - t0, 1),
            "psnr": res.get("PSNR"), "ate_rmse": res.get("ATE RMSE"),
            "ssim": res.get("MS-SSIM"), "depth_l1": res.get("Depth L1"),
        }
    except Exception as e:  # noqa: BLE001 - report, keep sweeping
        return {"seed": seed, "variant": variant, "error": repr(e)[:300],
                "wall_s": round(time.time() - t0, 1)}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", required=True)
    ap.add_argument("--env", default="{}",
                    help="JSON dict of env overrides for this variant")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--height", type=int, default=340)
    ap.add_argument("--width", type=int, default=600)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out-root", default="output",
                    help="each seed's run writes under "
                         "<out-root>/ab_<variant>_s<seed>")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the "
                           "CPU")
    backend = "pallas" if args.device == "cuda" else "interpret"
    os.environ.update(json.loads(args.env))
    os.environ.update({
        "SYN_H": str(args.height), "SYN_W": str(args.width),
        "SYN_FRAMES": str(args.frames),
    })
    rows = []
    for seed in args.seeds:
        row = run_seed(args.variant, seed, backend, args.device,
                       args.out_root)
        print("ABROW " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
