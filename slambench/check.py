"""Whether what the timed path produced is correct.

After the window the program's outputs are copied out: the backend's
estimated trajectory and global map, the frontend's local map and the
poses of its frames. The program is then freed, and the plain reference
(reference/) judges those outputs against what the camera saw, as a
served model's tokens are judged by the reference's logits:

  track_err_mm  the largest camera-centre error of a window frame in the
                backend's trajectory, after the rigid alignment of the
                whole trajectory (tracking loop, BA);
  front_mse     the largest colour MSE of the frontend's local map,
                rendered by the reference at the poses of up to three of
                its frames, against those frames, over the pixels the
                render covers (alpha > 0.5: a frame that is no keyframe
                may leave up to tau_k of its pixels to the next one)
                (frontend mapping);
  global_mse    the largest colour MSE, over every pixel (global_mse_cov:
                over the pixels the render covers), of the
                backend's global map at the backend's poses of up to
                three window frames of submaps merged before the last one
                (the last one's donors enter at 1% opacity and are made
                opaque by later mapping) (the backend's fused mapping and
                BA steps);
  front_depth_mm, global_depth_mm  the mean absolute depth error of the
                same renders (mm), over pixels the render covers;
  global_uncovered  the largest share of a global view's pixels that the
                render leaves uncovered (alpha <= 0.5);
  merged_uncovered_median  the median of that share over the frames of
                every submap merged after the first and before the last
                one (at most MERGED_VIEWS, evenly spaced): those submaps'
                donors enter at 1% opacity, and only the backend's mapping
                steps make them opaque before its prune reaps them (the
                backend's fused mapping steps).

The frames are drawn from the seed. Each number has a limit
(limits/<cell>.json); ``correct`` holds when every window frame came
back finite and each number is at or under its limit.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from .reference import render2dgs, trajectory

FIELDS = ("xyz", "log_scales", "quats", "opacity_logit", "rgb")
N_VIEWS = 3
MERGED_VIEWS = 24


def _params(gm) -> dict:
    act = gm.active
    return {f: getattr(gm.params, f)[act].detach().float().clone()
            for f in FIELDS}


def collect(cell) -> dict:
    """Copies of the program's outputs the check judges."""
    fe, be = cell.frontend, cell.backend
    be.wait()
    out = {"w2cs": [np.asarray(w) for w in be.local_maps.get_w2cs()],
           "global": _params(be.map), "local": _params(fe.map),
           "local_frames": [], "submap_of": {}}
    for lm in be.local_maps:
        for f in lm.frames:
            out["submap_of"].setdefault(f.time_idx, lm.lmid)
    for f in fe.local_frames:
        w = getattr(f, "_w2c_host", None)
        if w is None:
            w = f.get_w2c.detach().cpu().numpy()
        out["local_frames"].append((f.time_idx, np.asarray(w, np.float32)))
    if cell.device.type == "cuda":
        torch.cuda.synchronize()
    return out


def free(cell) -> None:
    """Drop the program's objects and the feeder's frames."""
    cell.stop_feeder()
    for name in ("frontend", "backend", "to_backend", "data_flow"):
        setattr(cell, name, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _view_errors(params, w2c, frames, t, cam, d_max, depth_near, depth_far):
    """(colour MSE over every pixel, over covered pixels, depth L1 mm over
    covered pixels, share of pixels not covered) of the reference's render
    at ``w2c`` against frame ``t``."""
    color, depth = frames.truth(t)
    dev = params["xyz"].device
    r = render2dgs.render(params, w2c, cam, d_max)
    color, depth = color.to(dev), depth.to(dev)
    err = ((r["color"] - color) ** 2).mean(-1)
    cov = r["alpha"] > 0.5
    mse_cov = float(err[cov].mean()) if cov.any() else float("inf")
    d = r["depth"]
    ok = (d > depth_near) & (d < depth_far) & (depth > 1e-5)
    dl1 = float(torch.abs(d - depth)[ok].mean()) * 1000 if ok.any() else 1e9
    return float(err.mean()), mse_cov, dl1, 1.0 - float(cov.float().mean())


def judge(outputs: dict, frames, first_t: int, config: dict, seed: int,
          device) -> dict:
    """The numbers ``correct`` compares."""
    cam_cfg = config["cameras"]
    k = np.asarray(cam_cfg["intrinsics"])
    cam = render2dgs.Cam(cam_cfg["height"], cam_cfg["width"], float(k[0][0]),
                         float(k[1][1]), float(k[0][2]), float(k[1][2]))
    d_max = int(config["tpu"]["max_tiles_per_gaussian"])
    near = float(config["render"]["depth_near"])
    far = float(config["render"]["depth_far"])
    rng = np.random.default_rng([int(seed), 1])
    nums = {}

    w2cs = outputs["w2cs"]
    gts = [frames.c2w(t) for t in range(len(w2cs))]
    err = trajectory.centre_errors(w2cs, gts)
    window = [t for t in range(len(w2cs)) if t >= first_t]
    nums["track_err_mm"] = (float(err[window].max()) * 1000 if window
                            else float("inf"))

    def views(params, poses):
        e = [_view_errors(params, w2c, frames, t, cam, d_max, near, far)
             for t, w2c in poses]
        return [max(x) for x in zip(*e)]

    g = {f: v.to(device) for f, v in outputs["global"].items()}
    sub = outputs["submap_of"]
    last = max(sub.values()) if sub else 0
    older = [t for t in window if sub.get(t, last) < last] or window
    pick = (rng.choice(older, size=min(N_VIEWS, len(older)), replace=False)
            if older else [])
    if len(pick):
        (nums["global_mse"], nums["global_mse_cov"], nums["global_depth_mm"],
         nums["global_uncovered"]) = views(
            g, [(int(t), w2cs[int(t)]) for t in sorted(pick)])
    else:
        for k in ("global_mse", "global_mse_cov", "global_depth_mm",
                  "global_uncovered"):
            nums[k] = float("inf")
    merged = sorted(t for t, m in sub.items()
                    if 0 < m < last and t < len(w2cs))
    if len(merged) > MERGED_VIEWS:
        merged = [merged[i] for i in np.linspace(
            0, len(merged) - 1, MERGED_VIEWS).round().astype(int)]
    unc = [_view_errors(g, w2cs[t], frames, t, cam, d_max, near, far)[3]
           for t in merged]
    nums["merged_uncovered_median"] = (float(np.median(unc)) if unc
                                       else float("inf"))
    del g
    loc = {f: v.to(device) for f, v in outputs["local"].items()}
    lf = outputs["local_frames"]
    idx = sorted(set([0, len(lf) - 1]) | set(
        rng.choice(len(lf), size=min(N_VIEWS, len(lf)), replace=False)
        .tolist()))[:N_VIEWS]
    _, nums["front_mse"], nums["front_depth_mm"], _ = views(
        loc, [lf[i] for i in idx])
    return nums


def verdict(nums: dict, limits: dict, attempted: int, failed: int) -> tuple:
    """(correct, {name: {value, limit}}) over the numbers with a limit."""
    compared = {k: {"value": nums[k], "limit": float(v)}
                for k, v in limits.items()}
    ok = (attempted > 0 and failed == 0
          and all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values()))
    return bool(ok), compared
