"""Stage-by-stage time of a backend task at the full-width bench shape
(port of tools/backend_probe.py).

Builds a backend-shaped global map directly: the capacity of the
full-width merge peak (``bucket_capacity(2.36e6)``, 2,883,584 rows), its
active rows from the synthetic frames 0, 12 and 24 unprojected at
PROBE_H x PROBE_W. Then it clocks each stage of a backend task between
device fences:

  bin_full            the per-task binning (preprocess, slab sort, pack)
  mapping_step        one mapping iteration (re-bins inside)
  mapping_loop x4     the fused 4-task batch the drain runs, dense and at
                      coarse stride 3 (the post-prune batches)
  tracking_step       one backend tracking task (re-bins per step)
  tracking_step cached  bin_for_tracking at the effective pose, autograd
                      through render_tracking(pre_w2c=...) and the
                      tracking loss, then the pose's Adam step

each under the factor budget r_max = 1.75 x capacity and again under a
demand-keyed ``pair_cap`` (the bin's demand x 1.3, rounded up to 2^17
rows). A stage's time is the wall time of ``PROBE_REPS`` calls (2 for the
x4 batches, or PROBE_REPS if fewer) between two fences, after one warm
call, in ms per call; the host reads inside a stage (each mapping step's
overflow test) are part of it.

    python -m gaus_slam_tpu_torch.tools.backend_probe [--device cuda|cpu]

Env: PROBE_H, PROBE_W, PROBE_REPS (680, 1200, 4). On the card the stages
run the hand-written kernels; ``--device cpu`` runs their plain versions.
Prints ``[probe]`` lines, the peak device memory, and a closing JSON line
with the JAX tool's keys (``demand``; per budget ``bin``, ``map1``,
``map4``, ``map4c``, ``trk``, ``trkc``) beside the map and bin numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

# the full-width merge peak the map stands in for (~2.35M actives)
N_TARGET = int(2.36e6)
FRAMES = (0, 12, 24)


def _env():
    return (int(os.environ.get("PROBE_H", 680)),
            int(os.environ.get("PROBE_W", 1200)),
            int(os.environ.get("PROBE_REPS", 4)))


def _frame(ds, t, dev):
    """(color [H, W, 3] in [0, 1], depth [H, W], w2c [4, 4]) of frame t."""
    color, depth, _, c2w = ds[t]
    depth = np.asarray(depth)
    if depth.ndim == 3:
        depth = depth[..., 0]
    return (torch.as_tensor(np.asarray(color / 255.0, np.float32), device=dev),
            torch.as_tensor(np.asarray(depth, np.float32), device=dev),
            torch.as_tensor(np.linalg.inv(c2w), dtype=torch.float32,
                            device=dev))


def build_map(h: int, w: int, device, n_target: int = N_TARGET):
    """(dataset, camera at the identity, map): a map of
    ``bucket_capacity(n_target, 2^17, 1.2)`` rows holding the valid
    pixels of synthetic frames 0, 12 and 24, unprojected in that order
    (tools/backend_probe.py:59-84)."""
    from ..data.synthetic import SyntheticDataset
    from ..models import gaussians as G
    from ..ops.camera import camera_from_intrinsics
    from ..ops.geometry import (depth_scale_init, normals_from_points,
                                points_from_depth, valid_depth_mask)
    from ..ops.se3 import invert_se3, transform_points

    dev = torch.device(device)
    ds = SyntheticDataset(height=h, width=w, num_frames=30)
    cam0 = camera_from_intrinsics(h, w, ds.intrinsics, np.eye(4), device=dev)
    gm = G.empty_map(G.bucket_capacity(n_target, 1 << 17, 1.2, 0), dev)
    for t in FRAMES:
        color, depth, w2c = _frame(ds, t, dev)
        cam = cam0.replace_w2c(w2c)
        pts_cam = points_from_depth(depth, cam)
        pts_w = transform_points(invert_se3(w2c), pts_cam.reshape(-1, 3))
        normals = normals_from_points(pts_w.reshape(pts_cam.shape))
        gm = G.add_gaussians(gm, pts_w.reshape(-1, 3), color.reshape(-1, 3),
                             normals.reshape(-1, 3),
                             depth_scale_init(depth, cam).reshape(-1),
                             valid_depth_mask(depth).reshape(-1))
    return ds, cam0, gm


def pair_cap_for(demand: int) -> int:
    """The demand-keyed pair budget: demand x 1.3 rounded up to 2^17 rows."""
    q = 1 << 17
    return -(-int(demand * 1.3) // q) * q


def main(argv=None, n_target: int = N_TARGET) -> dict:
    """Runs the probe; returns the closing JSON's dict. ``n_target`` sizes
    the map (the command line always takes the JAX tool's 2.36e6)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from ..models.frame import (LrSchedule, init_exposure, init_pose,
                                pose_adam_step)
    from ..ops import binning as B
    from ..ops.composite_ref import frame_to_tiles
    from ..render import (RenderOptions, bin_for_tracking, bin_full,
                          render_tracking)
    from ..slam.loss import LossConfig, tracking_loss
    from ..slam.steps import (MapConfig, TrackConfig, backend_tracking_step,
                              mapping_loop, mapping_step)
    from ..utils.fence import device_fence

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the "
                           "CPU")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(dev)
    backend = "pallas" if dev.type == "cuda" else "interpret"
    h, w, reps_default = _env()
    reps4 = min(2, reps_default)

    ds, cam0, gm = build_map(h, w, dev, n_target)
    cap = gm.capacity
    n_act = int(gm.n_active)
    print(f"[probe] map: capacity={cap} active={n_act} ({h}x{w}, "
          f"{dev}, backend {backend})", flush=True)

    color, depth, w2c = _frame(ds, FRAMES[-1], dev)
    grid = B.make_grid(cam0, 16, 16)
    gt = frame_to_tiles(color, depth, grid)
    lcfg = LossConfig()
    mcfg = MapConfig(lrs=(("opacity_lr", 0.05), ("rgb_lr", 0.0025),
                          ("rotation_lr", 0.001), ("scaling_lr", 0.001),
                          ("xyz_lr", 0.0001)))
    tcfg = TrackConfig(num_iters=1, converged_th=-1.0,
                       rot_sched=LrSchedule(1e-4, 0.0, 40),
                       trans_sched=LrSchedule(5e-4, 0.0, 40))
    exp = init_exposure(dev)
    sched = LrSchedule(0.0, 0.0, 1)
    cam = cam0.replace_w2c(w2c)
    pose = init_pose(np.eye(4, dtype=np.float32), device=dev)
    w2cs4 = torch.stack([w2c] * 4)
    gts4 = torch.stack([gt] * 4)

    def clock(label, f, *a, reps=reps_default):
        f(*a)
        device_fence(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            f(*a)
        device_fence(dev)
        dt = (time.perf_counter() - t0) / reps * 1000
        print(f"[probe] {label}: {dt:.3f} ms", flush=True)
        return dt

    results = {"capacity": cap, "n_active": n_act}
    for tag in ("factor1.75", "paircap"):
        kw = dict(grid=grid, backend=backend, pair_budget_factor=1.75,
                  max_tiles_per_gaussian=4)
        if tag == "paircap":
            kw["pair_cap"] = pair_cap_for(results["demand"])
            print(f"[probe] pair_cap={kw['pair_cap']} (demand "
                  f"{results['demand']}, factor r_max "
                  f"{RenderOptions(**dict(kw, pair_cap=0)).r_max(cap)})",
                  flush=True)
        opts = RenderOptions(**kw)

        def map1(gm_):
            return mapping_step(gm_, w2c, gt, exp, False, sched, cam0, opts,
                                mcfg, lcfg)

        def map4(gm_, stride=1):
            return mapping_loop(gm_, w2cs4, gts4, cam0, opts, mcfg, lcfg,
                                rebin_every=1, coarse_stride=stride)

        def track1(gm_, pose_):
            return backend_tracking_step(gm_, pose_, w2c, gt, cam0, opts,
                                         tcfg, lcfg)

        def track1_cached(gm_, pose_):
            # the pose gradient reduces over the pairs of a cache binned
            # once at the effective pose
            cache = bin_for_tracking(gm_, cam0.replace_w2c(w2c @ pose_.w2c),
                                     opts)
            quat = pose_.quat.detach().requires_grad_()
            trans = pose_.trans.detach().requires_grad_()
            out = render_tracking(cache, quat, trans, cam0, opts,
                                  pre_w2c=w2c)
            loss, _ = tracking_loss(out, gt, lcfg)
            g_q, g_t = torch.autograd.grad(loss, (quat, trans))
            return pose_adam_step(pose_, g_q, g_t, tcfg.rot_sched,
                                  tcfg.trans_sched, tcfg.betas)

        bins = bin_full(gm.params, gm.active, cam, opts)
        stats = {"r_max": opts.r_max(cap), "demand": int(bins.demand),
                 "num_pairs": int(bins.num_pairs),
                 "overflow": bool(bins.overflow), "pair_cap": opts.pair_cap}
        del bins
        print(f"[probe] {tag}: r_max={stats['r_max']} demand="
              f"{stats['demand']} num_pairs={stats['num_pairs']} "
              f"overflow={stats['overflow']}", flush=True)
        results.setdefault("demand", stats["demand"])

        t_bin = clock(f"{tag} bin_full", bin_full, gm.params, gm.active, cam,
                      opts)
        t_map = clock(f"{tag} mapping_step", map1, gm)
        t_map4 = clock(f"{tag} mapping_loop x4", map4, gm, reps=reps4)
        t_trk = clock(f"{tag} tracking_step", track1, gm, pose)
        t_map4c = clock(f"{tag} mapping_loop x4 coarse3", map4, gm, 3,
                        reps=reps4)
        t_trkc = clock(f"{tag} tracking_step cached", track1_cached, gm,
                       pose)
        results[tag] = dict(bin=t_bin, map1=t_map, map4=t_map4,
                            map4c=t_map4c, trk=t_trk, trkc=t_trkc)
        results.setdefault("bins", {})[tag] = stats

    if dev.type == "cuda":
        results["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
        print(f"[probe] peak device memory {results['peak_mib']:.1f} MiB "
              f"({torch.cuda.get_device_name(dev)})", flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
