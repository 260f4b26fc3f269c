"""Stage-by-stage cost of a tracking and a mapping step at the bench's
size (port of tools/microbench.py).

Builds a synthetic surfel map shaped like the 340x600 steady state
(204000 active gaussians of a 262144 capacity, ~1 px projected sigma,
10% of them 4x larger), from numpy draws of the JAX tool's distributions
(seed 0), and times each stage of the render / optimize pipeline:

    pre      preprocess of the map
    bin      bin_gaussians (the slab sort)
    expand   pack_pair_attrs + expand_pairs (the pair gather)
    fwd      K3, the forward without stash
    bwd      K5, the reference render backend's backward
    reduce   K4's reduction of pair gradients to gaussians
             (Binning.slab_scatter_grads)
    fwds     K1, the forward with stash
    bwds     K2, the stashed backward
    track    tracking_loop, 10 iterations
    map      mapping_step (binning, render, loss, Adam)

On a card each stage is timed between CUDA events over MB_REPS calls
after two warm-up calls, in device milliseconds, and one more call is
profiled for its launches: graph launches (``track`` and ``map`` replay
the steps captured by slam/programs.py) and kernels launched outside a
graph. ``--device cpu`` runs the plain versions, after one warm-up call,
and times them on the host clock (a CPU time, not a device one).

    python -m gaus_slam_tpu_torch.tools.microbench [--device cuda|cpu] \
        [stage ...]

Env: MB_H MB_W MB_N MB_CAP MB_DMAX MB_BUDGET MB_REPS, as the JAX tool.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

STAGES = ("pre", "bin", "expand", "fwd", "bwd", "reduce", "fwds", "bwds",
          "track", "map")


def _env():
    return dict(H=int(os.environ.get("MB_H", 340)),
                W=int(os.environ.get("MB_W", 600)),
                N=int(os.environ.get("MB_N", 204000)),
                CAP=int(os.environ.get("MB_CAP", 262144)),
                DMAX=int(os.environ.get("MB_DMAX", 9)),
                BUDGET=float(os.environ.get("MB_BUDGET", 4)),
                REPS=int(os.environ.get("MB_REPS", 5)))


def make_scene(h, w, n_act, cap, dev, seed=0):
    """(camera, map): ``cap`` surfels in front of a 300 px focal camera at
    the identity, the first ``n_act`` active."""
    from ..models import gaussians as G
    from ..ops.camera import Camera

    fx = fy = 300.0
    cam = Camera(h, w, fx, fy, w / 2.0, h / 2.0,
                 torch.eye(4, device=dev))
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 4.0, cap)
    u = rng.uniform(0.02, 0.98, (cap, 2))
    xyz = np.stack([(u[:, 0] * w - cam.cx) * z / fx,
                    (u[:, 1] * h - cam.cy) * z / fy, z], -1)
    # sigma ~ z/f => ~1 px projected; 10% bigger splats like grown ones
    big = rng.uniform(size=cap) < 0.1
    sc = z / fx * np.where(big, 4.0, 1.0) * rng.uniform(0.7, 1.5, cap)
    q = rng.normal(size=(cap, 4)) * 0.1
    q[:, 0] += 1.0
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    params = G.Params(
        xyz=t(xyz), log_scales=t(np.log(np.stack([sc, sc], -1))),
        quats=t(q / np.linalg.norm(q, axis=-1, keepdims=True)),
        opacity_logit=torch.full((cap, 1), 1.5, device=dev),
        rgb=t(rng.uniform(size=(cap, 3))))
    gm = G.GaussianMap(
        params=params, m=G._zeros_params(cap, dev),
        v=G._zeros_params(cap, dev),
        step=torch.tensor(10, dtype=torch.int32, device=dev),
        active=torch.arange(cap, device=dev) < n_act,
        n_active=torch.tensor(n_act, dtype=torch.int32, device=dev))
    return cam, gm


def _launches(fn, *args) -> str:
    """One more call of ``fn`` under torch.profiler: its graph launches and
    the kernels it launched outside a graph (slam/programs.py captures the
    steps)."""
    from torch.profiler import ProfilerActivity, profile

    from .sync_audit import count_launches

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    n = count_launches(prof.key_averages())
    return f"graphs {n['graphs']}, kernels outside a graph {n['kernels']}"


def _timer(dev, reps):
    def bench(name, fn, *args):
        for _ in range(2 if dev.type == "cuda" else 1):
            fn(*args)
        launches = ""
        if dev.type == "cuda":
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(reps):
                fn(*args)
            t1.record()
            torch.cuda.synchronize()
            ms = t0.elapsed_time(t1) / reps
            launches = f"  (a call: {_launches(fn, *args)})"
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(*args)
            ms = (time.perf_counter() - t0) / reps * 1e3
        print(f"{name:34s} {ms:9.3f} ms{launches}", flush=True)
        return ms
    return bench


def main(argv=None) -> dict:
    """{stage: ms per call}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stages", nargs="*",
                    help=f"stages to time, of {STAGES} (default all)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    want = set(args.stages) or set(STAGES)
    if want - set(STAGES):
        ap.error(f"unknown stages {sorted(want - set(STAGES))}")

    from ..models.frame import LrSchedule, init_exposure, init_pose
    from ..ops import binning as B
    from ..ops.composite_ref import image_to_tiles
    from ..ops.preprocess import pack_pair_attrs, preprocess
    from ..ops.raster_backward import (raster_backward,
                                       raster_backward_stash)
    from ..ops.raster_forward import raster_forward, raster_forward_stash
    from ..render import RenderOptions, bin_for_tracking, expand_pairs
    from ..slam.loss import LossConfig
    from ..slam.steps import MapConfig, TrackConfig, mapping_step, \
        tracking_loop

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the "
                           "CPU")
    dev = torch.device(args.device)
    e = _env()
    H, W, CAP, DMAX = e["H"], e["W"], e["CAP"], e["DMAX"]
    cam, gm = make_scene(H, W, e["N"], CAP, dev)
    grid = B.make_grid(cam, 16, 16)
    opts = RenderOptions(grid=grid, pair_budget_factor=e["BUDGET"],
                         max_tiles_per_gaussian=DMAX)
    r_max = opts.r_max(CAP)
    bench = _timer(dev, e["REPS"])
    where = (torch.cuda.get_device_name(0) if dev.type == "cuda"
             else "cpu (host time)")
    print(f"scene: {H}x{W}, n={e['N']}/{CAP}, d_max={DMAX}, r_max={r_max}, "
          f"device={where}", flush=True)

    def f_pre(gm):
        p = gm.params
        return preprocess(p.xyz, torch.exp(p.log_scales), p.quats,
                          torch.sigmoid(p.opacity_logit[:, 0]), cam,
                          active=gm.active)

    def f_bin(pre):
        return B.bin_gaussians(pre, grid, r_max=r_max,
                               max_tiles_per_gaussian=DMAX)

    def f_expand(pre, gm, bins):
        return expand_pairs(pack_pair_attrs(pre, gm.params.rgb).T, bins,
                            DMAX).contiguous()

    kw = dict(grid=grid, use_sa=True, need_normal=True)
    ms = {}
    with torch.no_grad():
        pre = f_pre(gm)
        bins = f_bin(pre)
        pattrs = f_expand(pre, gm, bins)
        ts, te = bins.tile_start, bins.tile_stop
        out = raster_forward(pattrs, ts, te, **kw)
        n_pairs = int(bins.num_pairs)
        print(f"pairs={n_pairs} overflow={bool(bins.overflow)} "
              f"budget={r_max}", flush=True)
        stages = {
            "pre": ("preprocess [N]", f_pre, gm),
            "bin": ("bin_gaussians (slab sort)", f_bin, pre),
            "expand": ("pack + expand_pairs gather", f_expand, pre, gm, bins),
            "fwd": ("K3 forward", lambda: raster_forward(pattrs, ts, te,
                                                         **kw)),
            "bwd": ("K5 backward (reference backend)", lambda:
                    raster_backward(pattrs, ts, te, out, out * 1e-3, **kw)),
        }
        d_pairs = raster_backward(pattrs, ts, te, out, out * 1e-3, **kw)
        stages["reduce"] = ("K4 slab grad reduction", lambda:
                            bins.slab_scatter_grads(d_pairs.T.contiguous(),
                                                    CAP, d_max=DMAX))
        out_s, stash, kexit = raster_forward_stash(pattrs, ts, te, **kw)
        stages["fwds"] = ("K1 forward (stash)", lambda:
                          raster_forward_stash(pattrs, ts, te, **kw))
        stages["bwds"] = ("K2 backward (stashed)", lambda:
                          raster_backward_stash(pattrs, ts, te, stash, kexit,
                                                out_s, out_s * 1e-3, **kw))
        for key in STAGES[:8]:
            if key in want:
                name, fn, *a = stages[key]
                ms[key] = bench(name, fn, *a)

    lcfg = LossConfig()
    rng = np.random.default_rng(2)
    gt = torch.cat([torch.as_tensor(rng.uniform(size=(3, H, W)).astype(
        np.float32), device=dev), torch.full((1, H, W), 2.0, device=dev)])
    gt_tiled = image_to_tiles(gt, grid)
    w2c = torch.eye(4, device=dev)
    if "track" in want:
        tcfg = TrackConfig(num_iters=10, converged_th=-1.0,
                           rot_sched=LrSchedule(4e-4, 1e-4, 30),
                           trans_sched=LrSchedule(2e-3, 4e-4, 30))
        cache = bin_for_tracking(gm, cam, opts)
        pose = init_pose(w2c, device=dev)
        ms["track"] = bench("tracking_loop (10 iters)", lambda: tracking_loop(
            cache, pose, gt_tiled, cam, opts, tcfg, lcfg))
    if "map" in want:
        mcfg = MapConfig(lrs=(("opacity_lr", 5e-2), ("rgb_lr", 2.5e-3),
                              ("rotation_lr", 1e-3), ("scaling_lr", 1e-3),
                              ("xyz_lr", 1e-4)))
        exp0 = init_exposure(device=dev)
        sched = LrSchedule(5e-3, 1e-4, 60)
        ms["map"] = bench("mapping_step (full)", lambda: mapping_step(
            gm, w2c, gt_tiled, exp0, False, sched, cam, opts, mcfg, lcfg))
    return ms


if __name__ == "__main__":
    main()
