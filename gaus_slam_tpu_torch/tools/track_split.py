"""Where a tracking iteration's device time goes, at a full-resolution
level and at a stride-2 checkerboard level: the whole iteration
(``steps._track_iter``), K1 and K2 alone, the per-pair preprocess
forward and backward down to the pose gradient as the tree's
``render_tracking`` runs it (the track-preprocess kernels K7 and K8, or
in an older tree the PyTorch chain) and the rest (loss, pose Adam, small
ops). A card only.

    python gaus_slam_tpu_torch/tools/track_split.py [--root DIR]

A Frontend runs the synthetic scene's first 3 frames at the tum cell's
480x640 with the map's capacity floored at its first bucket, 524,288,
and a pair budget of 2 per gaussian (so the tracking pair cache holds
2 x capacity rows), 120 tracking iterations, 72 of them on the stride-2
level; then the tracking pair cache is binned phase-major at its last
frame's tracked pose and each piece is captured in one CUDA graph and
timed between CUDA events over 20 replays (two replays of warm-up).
``--root``: the tree whose port to measure (an older commit unpacked
with ``git archive``); run this file by its path so that the package is
imported from there. Prints one JSON line: ms per piece and level, the
rows each level streams, the card.
"""
from __future__ import annotations

import argparse
import json
import os
import queue
import sys

H, W, FRAMES, CAPACITY, REPS = 480, 640, 3, 1 << 19, 20


def graph_ms(fn) -> float:
    """Device ms per call of ``fn`` captured in one CUDA graph (after one
    eager call on a side stream, the warm-up)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPS):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / REPS


def _chain(raw_t, w2c, q, cam_eye):
    """The PyTorch chain of an older tree's ``render_tracking`` (2DGS):
    the pair cache moved by the pose, then ``preprocess_t``."""
    from gaus_slam_tpu_torch.ops.preprocess import preprocess_t
    from gaus_slam_tpu_torch.ops.se3 import quat_multiply_rows

    xyz_cam_t = w2c[:3, :3] @ raw_t[0:3] + w2c[:3, 3][:, None]
    quats_cam_t = quat_multiply_rows(q, raw_t[5:9]).detach()
    return preprocess_t(xyz_cam_t, raw_t[3:5], quats_cam_t, raw_t[9],
                        raw_t[10:13], cam_eye)[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch

    import gaus_slam_tpu_torch
    from frame_split import synthetic_config
    from gaus_slam_tpu_torch.data.synthetic import SyntheticDataset
    from gaus_slam_tpu_torch.models.frame import init_pose
    from gaus_slam_tpu_torch.ops.composite_ref import frame_to_tiles
    from gaus_slam_tpu_torch.ops.raster_backward import raster_backward_stash
    from gaus_slam_tpu_torch.ops.raster_forward import raster_forward_stash
    from gaus_slam_tpu_torch.ops.se3 import pose_matrix, quat_normalize
    from gaus_slam_tpu_torch.render import (bin_for_tracking,
                                            track_coarse_budget)
    from gaus_slam_tpu_torch.slam import steps
    from gaus_slam_tpu_torch.slam.frontend import Frontend
    from gaus_slam_tpu_torch.utils.config import probe_cameras
    try:
        from gaus_slam_tpu_torch.ops.track_preprocess import (
            track_preprocess as preprocess)
    except ImportError:      # a tree without K7 / K8
        preprocess = _chain

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = synthetic_config(H, W, FRAMES, os.path.join(root, "output",
                                                       "track_split"))
    cfg["tpu"].update(pair_budget_factor=2, pair_budget_factor_frontend=2,
                      capacity_quantum=131072, frontend_capacity=CAPACITY)
    cfg["frontend"].update(num_tracking_iters=120, coarse_iters=72,
                           coarse_stride=2, converged_th=-1)
    ds = SyntheticDataset(height=H, width=W, num_frames=60)
    probe_cameras(cfg, ds[0][0], ds.intrinsics)
    fe = Frontend(cfg, queue.Queue(), device=dev)
    for t in range(FRAMES):
        color, depth, _, c2w = ds[t]
        fe.process_frame(t, np.asarray(color, np.float32) / np.float32(255),
                         np.asarray(depth), c2w)
        while not fe.to_backend.empty():
            fe.to_backend.get()

    s, gm = fe.sys, fe.map
    opts, cam = s.opts, s.cam
    # the last frame's tracked pose and its target
    color, depth, _, _ = ds[FRAMES - 1]
    w2c0 = fe.local_frames[-1].get_w2c.detach().cpu().numpy()
    pose = init_pose(w2c0.astype(np.float32), device=dev)
    gt = frame_to_tiles(
        torch.tensor(np.asarray(color, np.float32) / 255.0, device=dev),
        torch.tensor(np.asarray(depth), device=dev), opts.grid)
    with torch.no_grad():
        cache = bin_for_tracking(gm, cam.replace_w2c(pose.w2c), opts,
                                 coarse_strides=(2,))
    r = cache.raw_t.shape[1]
    tcfg, lcfg = s.track_front, s.lcfg
    carry = steps._carry0(dev)
    cam_eye = cam.replace_w2c(torch.eye(4, dtype=torch.float32, device=dev))
    gen = torch.Generator(device="cpu").manual_seed(0)
    out = {"root": os.path.dirname(os.path.dirname(
        os.path.abspath(gaus_slam_tpu_torch.__file__))),
        "shape": [H, W], "capacity": gm.capacity, "r": r,
        "n_active": int(gm.n_active), "reps": REPS,
        "card": torch.cuda.get_device_name(0), "levels": {}}
    for stride in (1, 2):
        hi = track_coarse_budget(r, 2) if stride == 2 else None
        rows = hi or r
        ids = (steps._level_tile_ids(opts.grid, 2, dev) if stride == 2
               else None)
        lvl = {"rows": rows}

        def it():
            steps._track_iter(cache, gt, pose, carry, cam, opts=opts,
                              tcfg=tcfg, lcfg=lcfg, stride=stride,
                              pair_hi=hi, masked=False)
        lvl["iter_ms"] = graph_ms(it)

        raw = cache.raw_t[:, :rows]
        d_attrs = torch.randn((24, rows), generator=gen).to(dev)

        def pre():
            quat = pose.quat.detach().requires_grad_()
            trans = pose.trans.detach().requires_grad_()
            attrs = preprocess(raw, pose_matrix(quat, trans),
                               quat_normalize(quat), cam_eye)
            torch.autograd.grad(attrs, (quat, trans), d_attrs)
        lvl["preprocess_ms"] = graph_ms(pre)
        with torch.no_grad():
            attrs = preprocess(raw, pose.w2c, quat_normalize(pose.quat),
                               cam_eye)
        if stride == 2:
            ts = torch.clamp(cache.tile_start, max=hi)
            te = torch.where(cache.tile_stop <= hi, cache.tile_stop, ts)
            ts, te = ts[ids.long()], te[ids.long()]
        else:
            ts, te = cache.tile_start, cache.tile_stop
        kw = dict(grid=opts.grid, use_sa=opts.use_sa,
                  need_normal=opts.normals_in_tracking, tile_ids=ids,
                  compute_dtype=opts.compute_dtype)
        o, stash, kexit = raster_forward_stash(attrs, ts, te, **kw)
        d_out = torch.randn(o.shape, generator=gen).to(dev)
        lvl["k1_ms"] = graph_ms(
            lambda: raster_forward_stash(attrs, ts, te, **kw))
        lvl["k2_ms"] = graph_ms(
            lambda: raster_backward_stash(attrs, ts, te, stash, kexit, o,
                                          d_out, **kw))
        lvl["rest_ms"] = (lvl["iter_ms"] - lvl["k1_ms"] - lvl["k2_ms"]
                          - lvl["preprocess_ms"])
        out["levels"][f"stride{stride}"] = lvl
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
