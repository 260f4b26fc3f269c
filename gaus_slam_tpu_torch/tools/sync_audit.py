"""Host waits inside the steps of the port's main path: each step runs once
under ``torch.cuda.set_sync_debug_mode``, which flags every call that
makes the host wait for the card (a stream or device synchronize, a
blocking copy to or from the card, a read of a device value).

    python -m gaus_slam_tpu_torch.tools.sync_audit [--mode warn|error] \
        [--profile] [--height 340] [--width 600] [step ...]

The steps, on the synthetic scene (configs/synthetic/config.py at
--height x --width; a Frontend over frames 0-10 makes the first submap,
which a Backend then merges):

    tracking   slam.steps.tracking_loop with the config's converged_th,
               from the last frame's pose on its own pair cache
    mapping    slam.steps.mapping_step of the Frontend (binning included)
    backend    Backend.process() on a task queue that starts with four
               mapping tasks of one class: one fused x4 mapping_loop
    sharded    parallel.sharded_ba_step over four slots of one card, with
               the Backend's owners (its map stepped in place)

Each step runs once unwatched first (the kernels build, the constant
caches fill), then once watched. "warn" prints every flagged call with
the port's frames of its stack, grouped by site; "error" stops a step at
its first flagged call. The explicit event wait of tracking_loop's lagged
convergence read is not a flagged call (an event synchronize), and is
counted by the loop itself (aux "host_waits"). ``--profile`` then times
each step once more under torch.profiler (``profile_window``): wall and
device busy ms, the idle share, and the host's ms in the CUDA calls that
wait for the card.
"""
from __future__ import annotations

import argparse
import collections
import os
import queue
import traceback
import warnings

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = ("tracking", "mapping", "backend", "sharded")
FLAGGED = "called a synchronizing CUDA operation"  # the debug mode's words


def build_state(h: int, w: int, device, n_frames: int = 11):
    """A Frontend over synthetic frames 0 .. n_frames-1 (a cut at frame 10
    at the config's 10-frame submaps) and a Backend that merged the first
    submap, its task queue not yet run."""
    import numpy as np

    from ..data.synthetic import SyntheticDataset
    from ..slam.backend import Backend
    from ..slam.frontend import Frontend
    from ..utils.config import load_config, probe_cameras

    old = {k: os.environ.get(k) for k in ("SYN_H", "SYN_W")}
    os.environ.update(SYN_H=str(h), SYN_W=str(w))
    try:
        cfg = load_config(os.path.join(os.path.dirname(PKG), "configs",
                                       "synthetic", "config.py"))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    cfg["backend"]["random_process"] = False
    ds = SyntheticDataset(height=h, width=w, num_frames=max(n_frames, 12))
    probe_cameras(cfg, ds[0][0], ds.intrinsics)
    fe = Frontend(cfg, queue.Queue(), device=device)
    lms = []
    for t in range(n_frames):
        color, depth, _, c2w = ds[t]
        fe.process_frame(t, np.asarray(color, np.float32) / np.float32(255),
                         np.asarray(depth), c2w)
        while not fe.to_backend.empty():
            lms.append(fe.to_backend.get())
    if not lms:
        raise RuntimeError(f"no submap was cut in {n_frames} frames")
    be = Backend(cfg, device=device)
    be.process_localmap(lms[0], multi_process=True)
    return dict(cfg=cfg, fe=fe, be=be, lm=be.local_maps[0])


def step_fns(st: dict) -> dict:
    """{step name: a callable that runs the step once}."""
    import torch

    from ..models.frame import LrSchedule, init_exposure
    from ..parallel import sharded_ba_step
    from ..render import bin_for_tracking
    from ..slam.steps import mapping_step, tracking_loop

    fe, be, lm = st["fe"], st["be"], st["lm"]
    s = fe.sys
    frame = fe.local_frames[-1]
    gt = fe._tile_gt(frame)
    w2c = frame.get_w2c.detach()
    pose = frame.pose
    exp0 = init_exposure(fe.device)
    sched = LrSchedule(0.0, 0.0, 1)
    out = {}

    # the frontend's own programs (slam/programs.py), as its frames run
    # them: the mapping step steps the frontend's map in place

    def tracking():
        cache = bin_for_tracking(fe.map, s.cam.replace_w2c(pose.w2c), s.opts)
        _, aux = tracking_loop(cache, pose, gt, s.cam, s.opts, s.track_front,
                               s.lcfg, owner=fe.programs)
        out["tracking"] = aux

    def mapping():
        mapping_step(fe.map, w2c, gt, exp0, False, sched, s.cam, s.opts,
                     s.mcfg, s.lcfg, owner=fe.programs)

    def backend():
        # four mapping tasks of one class at the queue's head: one fused
        # mapping_loop (slam/backend.py::process)
        be.task_queue.clear()
        be.task_queue.extend([("mapping", 0, True)] * be.MAP_BATCH)
        be.process()
        be.task_queue.clear()

    fids = [lm.saved_idxs[k % len(lm.saved_idxs)] for k in range(4)]
    w2cs = torch.stack([lm.get_frame_w2c(f).detach() for f in fids])
    gts = torch.stack([be._tile_gt(lm.frames[f]) for f in fids])
    devs = [be.device] * 4
    bs = be.sys

    def sharded():
        # the Backend's own programs: the map stepped in place
        with be.stream_context():
            be.map, _, _ = sharded_ba_step(devs, be.map, w2cs, gts, bs.cam,
                                           bs.opts, bs.mcfg, bs.lcfg,
                                           owners=be.ba_owners(devs))

    return dict(tracking=tracking, mapping=mapping, backend=backend,
                sharded=sharded), out


def port_frames(stack) -> list:
    """The frames of ``stack`` (traceback.extract_* entries) inside the
    port, innermost last, as 'path:line function'; the innermost three
    frames of the whole stack when none is."""
    def name(f):
        path = os.path.relpath(os.path.abspath(f.filename),
                               os.path.dirname(PKG))
        return f"{path}:{f.lineno} {f.name}"
    own = [name(f) for f in stack
           if os.path.abspath(f.filename).startswith(PKG)
           and not f.filename.endswith("sync_audit.py")]
    return own or ["(outside the port)"] + [name(f) for f in stack[-3:]]


def watch(fn, mode: str) -> list:
    """Run ``fn`` once under the sync debug mode; returns the flagged
    calls as (message, port frames of the stack)."""
    import torch

    found = []
    if mode == "warn":
        def show(message, category, filename, lineno, file=None, line=None):
            if FLAGGED in str(message):   # not the mode's own notice
                found.append((str(message),
                              port_frames(traceback.extract_stack()[:-1])))
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    else:
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError as e:
            if FLAGGED not in str(e):
                raise
            found.append((str(e).splitlines()[0], port_frames(
                traceback.extract_tb(e.__traceback__))))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return found


def audit(st: dict, mode: str = "error", steps=STEPS) -> dict:
    """{step: flagged calls}, each step run once unwatched, then once
    under the sync debug mode; also the tracking loop's aux."""
    import torch

    fns, out = step_fns(st)
    res = {}
    for name in steps:
        fns[name]()
        torch.cuda.synchronize()
        res[name] = watch(fns[name], mode)
    return res, out.get("tracking")


# CUDA runtime calls in which the host can wait for the card
HOST_WAIT_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync")
# runtime calls that launch work on the card: a kernel outside a graph,
# a captured graph (slam/programs.py)
KERNEL_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
GRAPH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")
# copies and fills issued outside a graph
COPY_CALLS = ("cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy2DAsync",
              "cudaMemcpyPeerAsync")


def count_launches(events) -> dict:
    """Launches in a profiler window's ``key_averages()``: kernels launched
    outside a graph, copies and fills issued outside a graph and graph
    launches (host calls), and the kernels the card ran, inside graphs or
    not."""
    out = {"kernels": 0, "copies": 0, "graphs": 0, "device_kernels": 0}
    for ev in events:
        if ev.key in KERNEL_CALLS:
            out["kernels"] += ev.count
        elif ev.key in COPY_CALLS:
            out["copies"] += ev.count
        elif ev.key in GRAPH_CALLS:
            out["graphs"] += ev.count
        elif ("CUDA" in str(getattr(ev, "device_type", ""))
              and not ev.key.startswith(("Memcpy", "Memset"))):
            out["device_kernels"] += ev.count
    return out


def profile_window(fn) -> dict:
    """One call of ``fn`` under torch.profiler (CPU and CUDA activity),
    closed by a device synchronize: wall ms, device busy ms (the sum of
    the kernels' own times), the eight busiest device ops (ms, count,
    name), the host's ms and count in each of HOST_WAIT_CALLS,
    ``launches`` (``count_launches``) and ``wait_ms``, the host's ms in stream synchronizes and synchronous
    copies (the closing device synchronize is the window's fence, not
    the step's; an event synchronize is the tracking loop's lagged read,
    counted apart)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows, waits = [], {}
    for ev in prof.key_averages():
        if ev.key in HOST_WAIT_CALLS:
            waits[ev.key] = [round(ev.cpu_time_total / 1e3, 3), ev.count]
        # device-side events only: a CPU op also reports the time of the
        # kernels it launched, which would count them twice
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    wait_ms = sum(waits.get(k, (0.0, 0))[0] for k in
                  ("cudaStreamSynchronize", "cudaMemcpy"))
    return dict(wall=wall, busy=sum(r[0] for r in rows), top=rows[:8],
                waits=dict(sorted(waits.items())), wait_ms=wait_ms,
                launches=count_launches(prof.key_averages()))


def profile_steps(st: dict, steps=STEPS) -> dict:
    """{step: profile_window of one call}, each step run once unprofiled
    first; "tracking" with the config's early exit."""
    import torch

    fns, _ = step_fns(st)
    out = {}
    for name in steps:
        fns[name]()
        torch.cuda.synchronize()
        out[name] = profile_window(fns[name])
    return out


def time_sharded(st: dict, devs: list, reps: int = 5) -> float:
    """Median wall ms of one sharded_ba_step of the backend's map over
    ``devs`` (the state's four keyframes cycled over them), between
    synchronizes of every card, after one unmeasured step; the Backend's
    owners for ``devs``, its map stepped in place."""
    import time

    import numpy as np
    import torch

    from ..parallel import sharded_ba_step

    be, lm = st["be"], st["lm"]
    bs = be.sys
    fids = [lm.saved_idxs[k % len(lm.saved_idxs)] for k in range(len(devs))]
    w2cs = torch.stack([lm.get_frame_w2c(f).detach() for f in fids])
    gts = torch.stack([be._tile_gt(lm.frames[f]) for f in fids])
    cards = sorted({d.index for d in devs} | {be.device.index})

    def fence():
        for i in cards:
            torch.cuda.synchronize(i)

    owners = be.ba_owners(devs)
    ms = []
    for r in range(reps + 1):
        fence()
        t0 = time.perf_counter()
        be.map, _, _ = sharded_ba_step(devs, be.map, w2cs, gts, bs.cam,
                                       bs.opts, bs.mcfg, bs.lcfg,
                                       owners=owners)
        fence()
        if r:
            ms.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ms))


def report(res: dict) -> None:
    for name, found in res.items():
        sites = collections.Counter(
            tuple(fr[-3:]) for _, fr in found)
        print(f"[sync_audit] {name}: {len(found)} flagged calls at "
              f"{len(sites)} sites", flush=True)
        for site, n in sites.most_common():
            print(f"[sync_audit]   x{n}: " + "  <-  ".join(reversed(site)),
                  flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="warn", choices=("warn", "error"))
    ap.add_argument("--height", type=int, default=340)
    ap.add_argument("--width", type=int, default=600)
    ap.add_argument("--profile", action="store_true",
                    help="also time each step under torch.profiler: wall, "
                         "device busy, idle share, host waits")
    ap.add_argument("--cards", type=int, default=0,
                    help="also time one sharded_ba_step with its shards on "
                         "cuda:0 .. cuda:N-1 beside N slots of cuda:0")
    ap.add_argument("steps", nargs="*", default=list(STEPS))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("sync_audit watches the card: no CUDA device")
    st = build_state(args.height, args.width, torch.device("cuda"))
    res, aux = audit(st, args.mode, args.steps)
    report(res)
    if args.cards > 1:
        n = args.cards
        slots = time_sharded(st, [torch.device("cuda", 0)] * n)
        cards = time_sharded(st, [torch.device("cuda", i) for i in range(n)])
        print(f"[sync_audit] sharded_ba_step, median wall ms of 5: {n} slots "
              f"of cuda:0 {slots:.3f}, shards on cuda:0-{n - 1} {cards:.3f}",
              flush=True)
    if args.profile:
        for name, w in profile_steps(st, args.steps).items():
            n = w["launches"]
            print(f"[sync_audit] profile {name}: wall {w['wall']:.3f} ms, "
                  f"device busy {w['busy']:.3f} ms, idle share "
                  f"{1 - w['busy'] / w['wall']:.3f}, launches: graphs "
                  f"{n['graphs']}, kernels outside a graph {n['kernels']}, "
                  f"copies and fills outside a graph {n['copies']}, "
                  f"kernels on the card {n['device_kernels']}; host waits "
                  f"{w['wait_ms']:.3f} ms; by call (ms, count) "
                  f"{w['waits']}; busiest: " + "; ".join(
                      f"{k[:70]} x{c} {ms:.3f} ms" for ms, c, k in w["top"]),
                  flush=True)
    if aux is not None:
        print(f"[sync_audit] tracking aux: "
              + ", ".join(f"{k} {aux[k]}" for k in ("iters", "host_waits",
                                                    "queued") if k in aux),
              flush=True)
    return res


if __name__ == "__main__":
    main()
