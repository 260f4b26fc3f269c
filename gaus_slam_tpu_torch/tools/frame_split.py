"""Where a frame's time goes, by kind of frame: the port's spans
(utils/trace.py) under a frame's ``frontend.process_frame`` span, the
host ms and the card ms of the captured programs launched in each, the
backend's tasks, the captures (``programs.capture`` spans), the
evaluation's ms per frame and the graph pools' MiB after the run.

    python gaus_slam_tpu_torch/tools/frame_split.py [--root DIR] \\
        [--mode frontend|driver|memory] [--height 340] [--width 600] \\
        [--frames N] [--device cuda]

``frontend``: a Frontend over the first N frames (24 by default: two
cuts) of the synthetic scene's 60-frame trajectory, its backend queue
drained and dropped, as chip_smoke.py's phase 3. ``driver``:
scripts/gaus.py's rgbd_slam over N frames (30 by default: phase 6's
schedule) with its backend and eval_final, whose wall time is taken
between device synchronizes, and frames/s over the frame loop (from the
first frame to eval_final, drains, final merge and refine included, as
chip_smoke.py's phase 6 counts it).
``memory``: the card's memory frame by frame in the benchmark's
``tum.handheld`` cell (slambench/loop.py's set-up, two warm-up cuts,
then N frames, 80 by default, one turn of the driver's loop at a time;
seed ``MEMORY_SEED``; a card only): after the set-up and after each frame
the MiB the caching allocator holds, its peak so far, the MiB allocated,
the graph pools' MiB, the submap and the backend map's capacity. Prints
one JSON line of those rows.
``--root``: the root of the tree whose port to measure (by default this
file's; an older commit unpacked with ``git archive``, say); run this
file by its path, not with ``-m``, so that the package is imported from
there. A tree without the port's tracing (``utils/trace.py``) is
refused. Its configs/synthetic/config.py is read from this file's tree.
The run is made under torch.profiler (CPU activity only: tracing is on
while it records), which fences nothing; the card's ms are the device
intervals of the programs' launches (CUDA events around each launch).
Prints one JSON line: per kind of frame (init, tracked, keyframe, cut)
the count and, per span name under the frame, the median host ms and
card ms over the frames that have it (the frame's own row under
``frontend.process_frame``); per backend task kind the count and the
median host and card ms; the captures' count and host ms by owner; eval
ms per frame and frames/s (driver); the graph pools' MiB and the card.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import queue
import sys
import time

FRAME = "frontend.process_frame"


def _medians(rows: list) -> dict:
    import numpy as np

    keys = sorted({k for r in rows for k in r})
    return {k: float(np.median([r[k] for r in rows if k in r]))
            for k in keys}


def summarize(recs: dict) -> dict:
    """``trace.records()`` of a run as the table above (without the run's
    own numbers)."""
    spans = recs["spans"]
    by_id = {s["id"]: s for s in spans}

    def root(s):
        """The frame or backend task span ``s`` lies in, or None."""
        while s is not None:
            if s["name"] in (FRAME, "backend.task"):
                return s
            s = by_id.get(s["parent"])
        return None

    def names(sid):
        """The distinct names of span ``sid`` and its ancestors up to its
        frame or task."""
        out, s = [], by_id.get(sid)
        while s is not None:
            if s["name"] not in out:
                out.append(s["name"])
            if s["name"] in (FRAME, "backend.task"):
                break
            s = by_id.get(s["parent"])
        return out

    host = collections.defaultdict(collections.Counter)
    card = collections.defaultdict(collections.Counter)
    for s in spans:
        r = root(s)
        if r is not None:
            host[r["id"]][s["name"]] += (s["t1_ns"] - s["t0_ns"]) / 1e6
    for iv in recs["intervals"]:
        r = root(by_id.get(iv["span"]))
        if r is not None:
            for name in names(iv["span"]):
                card[r["id"]][name] += (iv["t1_ns"] - iv["t0_ns"]) / 1e6
    kinds: dict = collections.defaultdict(list)
    tasks: dict = collections.defaultdict(list)
    for s in spans:
        if s["name"] in (FRAME, "backend.task"):
            into = kinds if s["name"] == FRAME else tasks
            into[s["attrs"].get("kind", "?")].append(s["id"])
    captures: dict = {}
    for s in spans:
        if s["name"] == "programs.capture":
            row = captures.setdefault(s["attrs"]["owner"], [0, 0.0])
            row[0] += 1
            row[1] += (s["t1_ns"] - s["t0_ns"]) / 1e6

    def table(groups):
        return {k: {"n": len(ids),
                    "host_ms": _medians([dict(host[i]) for i in ids]),
                    "device_ms": _medians([
                        {n: card[i][n] for n in host[i]} for i in ids])}
                for k, ids in sorted(groups.items())}

    return {"kinds": table(kinds), "tasks": table(tasks),
            "captures": captures}


def pool_mib() -> float:
    """MiB the caching allocator holds in graph pools (segments of a
    private pool)."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)) / 2**20


MEMORY_CELL = "tum.handheld"
MEMORY_SEED = 2147484011
MEMORY_COLUMNS = ("reserved_mib", "peak_reserved_mib", "allocated_mib",
                  "pool_mib", "submap", "backend_capacity")


def run_memory(n: int, device) -> dict:
    """``--mode memory``: the rows described above, the seconds of the
    set-up and of the frames, and of one ``torch.cuda.memory_snapshot``."""
    import torch

    from slambench import harness, registry
    from slambench.loop import Cell

    wl = registry.cell(registry.benchmark(), MEMORY_CELL)
    dev = torch.device(device)
    t0 = time.perf_counter()
    harness._load_kernels(dev)
    cell = Cell(registry.config(wl["config"]), registry.traffic(wl["traffic"]),
                MEMORY_SEED, device=dev, overrides=registry.overrides(
                    MEMORY_CELL))

    def reading():
        gm = cell.backend.map
        return [round(torch.cuda.memory_reserved(dev) / 2**20),
                round(torch.cuda.max_memory_reserved(dev) / 2**20),
                round(torch.cuda.memory_allocated(dev) / 2**20),
                round(pool_mib()), int(cell.frontend.cur_lmid),
                0 if gm is None else int(gm.capacity)]

    cell.start_feeder()
    try:
        cell.warm_up()
        out = {"cell": MEMORY_CELL, "seed": MEMORY_SEED,
               "columns": MEMORY_COLUMNS, "setup": reading(),
               "setup_s": time.perf_counter() - t0, "frames": []}
        t1 = time.perf_counter()
        while len(out["frames"]) < n:
            if cell.turn(handing=True):
                out["frames"].append(reading())
        cell.drain()
        out["frames_s"] = time.perf_counter() - t1
        out["end"] = reading()
        t2 = time.perf_counter()
        torch.cuda.memory_snapshot()
        out["snapshot_ms"] = 1e3 * (time.perf_counter() - t2)
    finally:
        cell.stop_feeder()
    return out


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


def traced(fn, *a, **kw):
    """``fn(*a, **kw)`` under torch.profiler (CPU activity: tracing on),
    then the card synchronised; returns (its result, trace.records())."""
    import torch

    from gaus_slam_tpu_torch.utils import trace

    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        res = fn(*a, **kw)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    recs = trace.records()
    trace.clear()
    return res, recs


def run_driver(cfg: dict, device) -> dict:
    """rgbd_slam on ``cfg``, eval_final timed between synchronizes, the
    frame loop from the first frame to eval_final."""
    import torch

    from gaus_slam_tpu_torch.scripts.gaus import rgbd_slam
    from gaus_slam_tpu_torch.slam.frontend import Frontend
    from gaus_slam_tpu_torch.utils import eval as E

    timing = {}
    orig, frame = E.eval_final, Frontend.process_frame

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = timing["t_eval"] = time.perf_counter()
        res = orig(*a, **kw)
        torch.cuda.synchronize()
        timing["eval_s"] = time.perf_counter() - t0
        return res

    def first_frame(fe, *a, **kw):
        timing.setdefault("t_loop", time.perf_counter())
        return frame(fe, *a, **kw)

    E.eval_final, Frontend.process_frame = timed, first_frame
    try:
        result = rgbd_slam(cfg, backend="pallas", device=device)
    finally:
        E.eval_final, Frontend.process_frame = orig, frame
    return dict(timing, loop_s=timing["t_eval"] - timing["t_loop"],
                result=result)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    ap.add_argument("--mode", default="frontend",
                    choices=("frontend", "driver", "memory"))
    ap.add_argument("--height", type=int, default=340)
    ap.add_argument("--width", type=int, default=600)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    if not os.path.exists(os.path.join(root, "gaus_slam_tpu_torch", "utils",
                                       "trace.py")):
        sys.exit(f"frame_split: {root} has no gaus_slam_tpu_torch/utils/"
                 f"trace.py: its port records no spans to split a frame by")
    sys.path.insert(0, root)
    import torch

    if args.mode == "memory":
        import gaus_slam_tpu_torch

        summary = {"root": os.path.dirname(os.path.dirname(os.path.abspath(
            gaus_slam_tpu_torch.__file__))),
            **run_memory(args.frames or 80, args.device),
            "card": torch.cuda.get_device_name(0)}
        print(json.dumps(summary), flush=True)
        return summary
    n = args.frames or (24 if args.mode == "frontend" else 30)
    out = os.path.join(root, "output", f"frame_split_{args.mode}_{n}")
    cfg = synthetic_config(args.height, args.width, n, out)
    cfg["backend"]["common_vis"] = False
    t0 = time.perf_counter()
    if args.mode == "frontend":
        _, recs = traced(run_frontend, cfg, args.height, args.width, n,
                         args.device)
        extra = {}
    else:
        res, recs = traced(run_driver, cfg, args.device)
        extra = {"eval_ms_per_frame": 1e3 * res["eval_s"] / n,
                 "frames_per_s": n / res["loop_s"],
                 "ate_rmse": res["result"]["ATE RMSE"],
                 "psnr": res["result"]["PSNR"]}
    wall = time.perf_counter() - t0
    import gaus_slam_tpu_torch

    summary = {"root": os.path.dirname(os.path.dirname(
        os.path.abspath(gaus_slam_tpu_torch.__file__))), "mode": args.mode,
        "frames": n, "shape": [args.height, args.width],
        "wall_s": wall, **summarize(recs), **extra}
    if torch.device(args.device).type == "cuda":
        summary.update(pool_mib=pool_mib(),
                       card=torch.cuda.get_device_name(0))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
