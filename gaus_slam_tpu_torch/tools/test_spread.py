"""Multi-seed spread of the synthetic full-SLAM run at the integration
test's scale (port of tools/test_spread.py): 48x64, 12 frames, the mesh
F-score on, one child process per seed.

Writes per-seed PSNR / ATE / Depth-L1 / MS-SSIM / F-score, their mean /
sd / min / max and the JAX tool's suggested bounds to --out (seeds
already there are skipped), and prints the summary. The workload string
names the device and the render backend the rows were taken with.

    python -m gaus_slam_tpu_torch.tools.test_spread --seeds 0 1 2 3 4 \
        [--device cuda|cpu] [--out artifacts/test_bounds_spread_torch.json]

On the card the driver runs the hand-written kernels ("pallas");
``--device cpu`` runs their plain versions ("interpret"). The file keeps
the JAX tool's name; it defines no test.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics as st
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG = os.path.join(ROOT, "configs", "synthetic", "config.py")
SCALE = dict(SYN_H="48", SYN_W="64", SYN_FRAMES="12")


def backend_for(device: str) -> str:
    return "pallas" if device == "cuda" else "interpret"


def workload(device: str, device_name: str) -> str:
    return (f"synthetic 48x64 x 12 frames, {device_name} "
            f"{backend_for(device)} (tests/test_full_slam.py scale)")


def run_seed(seed: int, device: str, out_root: str) -> dict:
    """One driver run at ``seed`` with the mesh evaluation on; prints and
    returns its row."""
    from ..scripts.gaus import rgbd_slam
    from ..utils.config import load_config

    os.environ.update(SCALE)
    os.environ["SEED"] = str(seed)
    config = load_config(CONFIG)
    out = os.path.join(out_root, f"spread_{device}_seed{seed}")
    shutil.rmtree(out, ignore_errors=True)
    config["vis_base_dir"] = out
    config["eval"]["eval_mesh"] = True
    result = rgbd_slam(config, backend=backend_for(device), device=device)
    row = {
        "seed": seed,
        "psnr": float(result["PSNR"]),
        "ate_rmse": float(result["ATE RMSE"]),
        "depth_l1": float(result["Depth L1"]),
        "ms_ssim": float(result["MS-SSIM"]),
        "fscore": float(result.get("Mesh F-score", float("nan"))),
    }
    print("SPREADROW " + json.dumps(row), flush=True)
    return row


def aggregate(rows, workload_name):
    """The JAX tool's summary of ``rows`` under ``workload_name``."""
    def agg(key):
        vs = [r[key] for r in rows]
        return {"mean": st.mean(vs),
                "sd": st.stdev(vs) if len(vs) > 1 else 0.0,
                "min": min(vs), "max": max(vs)}

    out = {"workload": workload_name, "rows": rows}
    if rows:
        out["stats"] = {k: agg(k) for k in
                        ("psnr", "ate_rmse", "depth_l1", "ms_ssim",
                         "fscore")}
        s = out["stats"]
        # bounds: ~max(1 dB, 2 sd) below the worst seed for PSNR; the
        # worst seed + 2 sd (floored) for the error metrics
        out["suggested_bounds"] = {
            "psnr_gt": round(s["psnr"]["min"]
                             - max(1.0, 2 * s["psnr"]["sd"]), 1),
            "ate_lt": round(s["ate_rmse"]["max"]
                            + max(0.005, 2 * s["ate_rmse"]["sd"]), 4),
            "depth_l1_lt": round(s["depth_l1"]["max"]
                                 + max(0.005, 2 * s["depth_l1"]["sd"]), 4),
            "fscore_gt": round(s["fscore"]["min"]
                               - max(0.1, 2 * s["fscore"]["sd"]), 2),
        }
    return out


def main(argv=None) -> dict:
    """Runs the missing seeds, one child process each; returns the
    summary written to --out (with --one-seed: that seed's row)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out",
                    default="artifacts/test_bounds_spread_torch.json")
    ap.add_argument("--out-root", default="output",
                    help="each seed's run writes under "
                         "<out-root>/spread_<device>_seed<seed>")
    ap.add_argument("--one-seed", type=int, default=None,
                    help="run this seed in this process and print its row")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the "
                           "CPU")
    if args.one_seed is not None:
        return run_seed(args.one_seed, args.device, args.out_root)
    name = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else "CPU")

    out_path = os.path.join(ROOT, args.out)
    rows = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            rows = json.load(f).get("rows", [])
    done = {r["seed"] for r in rows}
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for seed in args.seeds:
        if seed in done:
            continue
        # one child process per seed: the driver seeds the global RNGs
        # and the config reads its env when it loads
        proc = subprocess.run(
            [sys.executable, "-m", "gaus_slam_tpu_torch.tools.test_spread",
             "--one-seed", str(seed), "--device", args.device,
             "--out-root", args.out_root],
            cwd=ROOT, env=env, capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("SPREADROW "):
                rows.append(json.loads(line[len("SPREADROW "):]))
        if proc.returncode != 0:
            print(f"seed {seed} failed:\n{proc.stderr[-2000:]}", flush=True)
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(aggregate(rows, workload(args.device, name)), f,
                      indent=1)
    summary = aggregate(rows, workload(args.device, name))
    print(json.dumps(summary, indent=1), flush=True)
    return summary


if __name__ == "__main__":
    main()
