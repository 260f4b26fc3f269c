"""Where a frame's wall time goes, by kind of frame: the frontend's
``GAUS_PROFILE`` marks (slam/frontend.py: h2d, pose_init, tracking,
kf_test, densify, kf_mapping, prune, cut, and the cut's create_map),
the evaluation's ms per frame and the graph pools' MiB after the run.

    python gaus_slam_tpu_torch/tools/frame_split.py [--root DIR] \\
        [--mode frontend|driver] [--height 340] [--width 600] \\
        [--frames N] [--device cuda]

``frontend``: a Frontend over the first N frames (24 by default: two
cuts) of the synthetic scene's 60-frame trajectory, its backend queue
drained and dropped, as chip_smoke.py's phase 3. ``driver``:
scripts/gaus.py's rgbd_slam over N frames (30 by default: phase 6's
schedule) with its backend and eval_final, whose wall time is taken
between device synchronizes.
``--root``: the root of the tree whose port to measure (by default this
file's; an older commit unpacked with ``git archive``, say); run this
file by its path, not with ``-m``, so that the package is imported from
there. Its configs/synthetic/config.py is read from this file's tree.
The marks fence the device at each mark (utils/fence.py), so they split
a frame's wall time but add the fences' cost to it. Prints one JSON
line: per kind of frame (tracked, keyframe, cut) the count and the
median ms of each mark (create_map among a cut's), eval ms per frame
(driver), the graph pools' MiB and the card.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import queue
import sys
import time


def parse_marks(text: str) -> list:
    """The ``[prof] frame`` lines of a run as dicts of ms by mark, each
    with the ``create_map`` ms of the ``[prof] cut`` line printed during
    its frame."""
    frames, cut = [], None
    for line in text.splitlines():
        if line.startswith("[prof] cut: "):
            parts = dict(p.split("=") for p in line.split()[2:])
            cut = float(parts["create_map"].rstrip("ms"))
        elif line.startswith("[prof] frame "):
            marks = {k: float(v.rstrip("ms")) for k, v in
                     (p.split("=") for p in line.split()[2:])}
            if cut is not None:
                marks["create_map"], cut = cut, None
            frames.append(marks)
    return frames


def frame_kind(marks: dict) -> str:
    if "cut" in marks:
        return "cut"
    return "keyframe" if "densify" in marks else "tracked"


def summarize(frames: list) -> dict:
    import numpy as np

    out = {}
    for kind in ("tracked", "keyframe", "cut"):
        rows = [m for m in frames if frame_kind(m) == kind]
        keys = sorted({k for m in rows for k in m})
        out[kind] = {"n": len(rows), "median_ms": {
            k: float(np.median([m[k] for m in rows if k in m]))
            for k in keys}}
    return out


def pool_mib() -> float:
    """MiB the caching allocator holds in graph pools (segments of a
    private pool)."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)) / 2**20


def synthetic_config(h: int, w: int, n: int, out: str) -> dict:
    from gaus_slam_tpu_torch.utils.config import load_config

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(SYN_H=str(h), SYN_W=str(w), SYN_FRAMES=str(n), SYN_OUT=out)
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return load_config(os.path.join(repo, "configs", "synthetic",
                                        "config.py"))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def run_frontend(cfg: dict, h: int, w: int, n: int, device) -> None:
    """A Frontend over the first ``n`` frames of the synthetic scene's
    60-frame trajectory (chip_smoke.py's phases 3 and 13)."""
    import numpy as np

    from gaus_slam_tpu_torch.data.synthetic import SyntheticDataset
    from gaus_slam_tpu_torch.slam.frontend import Frontend
    from gaus_slam_tpu_torch.utils.config import probe_cameras

    ds = SyntheticDataset(height=h, width=w, num_frames=max(n, 60))
    probe_cameras(cfg, ds[0][0], ds.intrinsics)
    fe = Frontend(cfg, queue.Queue(), device=device)
    for t in range(n):
        color, depth, _, c2w = ds[t]
        fe.process_frame(t, np.asarray(color, np.float32) / np.float32(255),
                         np.asarray(depth), c2w)
        while not fe.to_backend.empty():
            fe.to_backend.get()


def run_driver(cfg: dict, device) -> dict:
    """rgbd_slam on ``cfg``, eval_final timed between synchronizes."""
    import torch

    from gaus_slam_tpu_torch.scripts.gaus import rgbd_slam
    from gaus_slam_tpu_torch.utils import eval as E

    timing = {}
    orig = E.eval_final

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig(*a, **kw)
        torch.cuda.synchronize()
        timing["eval_s"] = time.perf_counter() - t0
        return res

    E.eval_final = timed
    try:
        result = rgbd_slam(cfg, backend="pallas", device=device)
    finally:
        E.eval_final = orig
    return dict(timing, result=result)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--mode", default="frontend",
                    choices=("frontend", "driver"))
    ap.add_argument("--height", type=int, default=340)
    ap.add_argument("--width", type=int, default=600)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    import torch

    n = args.frames or (24 if args.mode == "frontend" else 30)
    out = os.path.join(root, "output", f"frame_split_{args.mode}_{n}")
    cfg = synthetic_config(args.height, args.width, n, out)
    cfg["backend"]["common_vis"] = False
    os.environ["GAUS_PROFILE"] = "1"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        if args.mode == "frontend":
            run_frontend(cfg, args.height, args.width, n, args.device)
            extra = {}
        else:
            res = run_driver(cfg, args.device)
            extra = {"eval_ms_per_frame": 1e3 * res["eval_s"] / n,
                     "ate_rmse": res["result"]["ATE RMSE"],
                     "psnr": res["result"]["PSNR"]}
    wall = time.perf_counter() - t0
    import gaus_slam_tpu_torch

    summary = {"root": os.path.dirname(os.path.dirname(
        os.path.abspath(gaus_slam_tpu_torch.__file__))), "mode": args.mode,
        "frames": n, "shape": [args.height, args.width],
        "wall_s": wall, "kinds": summarize(parse_marks(buf.getvalue())),
        **extra}
    if torch.device(args.device).type == "cuda":
        summary.update(pool_mib=pool_mib(),
                       card=torch.cuda.get_device_name(0))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
