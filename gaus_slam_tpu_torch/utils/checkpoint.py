"""Mid-run checkpoint / resume (port of gaus_slam_tpu/utils/checkpoint.py)
— an addition over the reference, which only saves end-of-run artifacts
(scene/__init__.py:9-27).

A checkpoint is written at a submap boundary (right after the backend
drained the submap's task queue) into a directory holding:

  * arrays.npz: the frontend's local map, the backend's global map, and
    every submap's optimizable rigid transform and exposure (Adam state
    included), keyed by the tree paths of the JAX package's state
    ("frontend_map/params/xyz", "transforms/0/quat", ...);
  * meta.json: host-side state — frame cursor, velocity model, loss EMA,
    dashboards series, and per-submap trajectory records (est/gt w2c of
    every frame) so evaluation works after resume. Its schema is the JAX
    package's.

The JAX package stores the arrays with orbax, which needs JAX, so a
checkpoint of one package does not load in the other;
``convert.run_state_from_jax`` carries a JAX checkpoint's restored
arrays into this layout.

Restore rebuilds the SLAM state at that boundary. Retained keyframe
images are not stored: restore reloads them from the dataset by
``time_idx``, so restored submaps keep their ``saved_idxs`` and the
backend's covis-mapping/tracking tasks continue to refine pre-checkpoint
submaps exactly like an uninterrupted run.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..models import gaussians as G
from ..models.frame import ExposureState, Frame, PoseState

POSE_FIELDS = ("quat", "trans", "m_q", "v_q", "m_t", "v_t", "step")
EXPOSURE_FIELDS = ("gain", "bias", "m", "v", "step")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _map_state(gm: G.GaussianMap) -> dict:
    return {
        "params": {f: _np(p) for f, p in zip(G.PARAM_FIELDS, gm.params)},
        "m": {f: _np(p) for f, p in zip(G.PARAM_FIELDS, gm.m)},
        "v": {f: _np(p) for f, p in zip(G.PARAM_FIELDS, gm.v)},
        "step": np.int32(_np(gm.step)),
        "active": _np(gm.active),
        "n_active": np.int32(int(gm.n_active)),
    }


def _step(a, device) -> torch.Tensor:
    """A saved step count as the port keeps it: a device int32 scalar."""
    return torch.as_tensor(np.array(a, np.int32).reshape(()), device=device)


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.array(v)
    return out


def _subtree(arrays: dict, prefix: str) -> dict:
    """{rest of the path: array} of the keys under ``prefix/``."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in arrays.items() if k.startswith(prefix + "/")}


def _map_from(arrays: dict, prefix: str, device) -> G.GaussianMap:
    def params(group):
        return G.Params(*(torch.as_tensor(
            arrays[f"{prefix}/{group}/{f}"], dtype=torch.float32,
            device=device) for f in G.PARAM_FIELDS))

    return G.GaussianMap(
        params=params("params"), m=params("m"), v=params("v"),
        step=_step(arrays[f"{prefix}/step"], device),
        active=torch.as_tensor(arrays[f"{prefix}/active"], dtype=torch.bool,
                               device=device),
        n_active=torch.as_tensor(arrays[f"{prefix}/n_active"],
                                 dtype=torch.int32, device=device))


def _state_from(sub: dict, fields, cls, device):
    vals = [torch.as_tensor(sub[f], dtype=torch.float32, device=device)
            for f in fields[:-1]]
    return cls(*vals, _step(sub["step"], device))


def run_state_arrays(frontend, backend) -> dict:
    """The checkpoint's arrays, flat: {tree path: numpy array}."""
    state = _flatten({"frontend_map": _map_state(frontend.map)})
    if backend is not None:
        state.update(backend_state_arrays(backend))
    return state


def backend_state_arrays(backend) -> dict:
    """The backend's part of the checkpoint, flat: {tree path: numpy
    array}: its map with the Adam moments, and each submap's transform
    and exposure. Empty before the first merge."""
    backend.wait()   # its own stream may still be writing the map
    state = {}
    if backend.map is not None:
        state["backend_map"] = _map_state(backend.map)
        state["transforms"] = {
            str(i): {f: np.int32(_np(lm.transform.step)) if f == "step"
                     else _np(getattr(lm.transform, f)) for f in POSE_FIELDS}
            for i, lm in enumerate(backend.local_maps)
            if lm.transform is not None
        }
        exposures = {
            str(i): {f: np.int32(_np(lm.exposure.step)) if f == "step"
                     else _np(getattr(lm.exposure, f))
                     for f in EXPOSURE_FIELDS}
            for i, lm in enumerate(backend.local_maps)
            if lm.exposure is not None
        }
        if exposures:
            state["exposures"] = exposures
    return _flatten(state)


def run_state_meta(frontend, backend, next_frame_idx: int) -> dict:
    """meta.json's host state, the JAX package's schema."""
    lms = []
    for lm in (backend.local_maps if backend is not None else []):
        lms.append({
            "lmid": lm.lmid,
            "tracking_ok": bool(lm.tracking_ok),
            "mapping_times": int(lm.mapping_times),
            "saved_idxs": [int(i) for i in lm.saved_idxs],
            "ref2f0": np.asarray(lm.ref2f0).tolist(),
            "map_desc": np.asarray(lm.map_desc).tolist(),
            "frames": [{
                "time_idx": int(f.time_idx),
                "frame_type": int(f.frame_type),
                "kfid": int(f.kfid),
                "est_w2c": np.asarray(f.est_w2c).tolist(),
                "gt_w2c": np.asarray(f.gt_w2c).tolist(),
                "est_exposure": [float(x) for x in f.est_exposure],
            } for f in lm.frames],
        })
    return {
        "next_frame_idx": int(next_frame_idx),
        # the frontend's live (uncut) submap
        "cur_frames": [{
            "time_idx": int(f.time_idx),
            "frame_type": int(f.frame_type),
            "kfid": int(f.kfid),
            "mapping_times": int(f.mapping_times),
            "w2c": _np(f.get_w2c).tolist(),
        } for f in frontend.local_frames],
        "cur_lmid": int(frontend.cur_lmid),
        "vel": np.asarray(frontend.vel).tolist(),
        "avg_depth_l1": float(frontend.avg_depth_l1),
        "depth_l1_rec": [float(x) for x in frontend.depth_l1_rec],
        "numpts_rec": [int(x) for x in frontend.numpts_rec],
        "tracking_flag": bool(frontend.tracking_flag),
        "totalpts_rec": [int(x) for x in backend.totalpts_rec]
        if backend is not None else [],
        # merge-peak history: feeds _merge_horizon and the never-shrink-
        # below-last-peak floor in _fit_capacity
        "peak_hist": [int(x) for x in getattr(backend, "_peak_hist", [])]
        if backend is not None else [],
        "ape_rec": [float(x) for x in getattr(backend, "ape_rec", [])]
        if backend is not None else [],
        "localmaps": lms,
    }


def save_run_state(path: str, frontend, backend,
                   next_frame_idx: int) -> None:
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    arrays = run_state_arrays(frontend, backend)
    # each file is written beside and renamed: never left half-written
    tmp = os.path.join(path, "arrays.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(path, "arrays.npz"))
    meta = run_state_meta(frontend, backend, next_frame_idx)
    with open(os.path.join(path, "meta.json.tmp"), "w") as f:
        json.dump(meta, f)
    os.replace(os.path.join(path, "meta.json.tmp"),
               os.path.join(path, "meta.json"))


def read_run_state(path: str) -> tuple[dict, dict]:
    """(arrays {tree path: numpy array}, meta) of a checkpoint directory."""
    path = os.path.abspath(path)
    with np.load(os.path.join(path, "arrays.npz")) as f:
        arrays = {k: f[k] for k in f.files}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return arrays, meta


def _images(dataset, time_idx: int, device):
    color, depth, _, c2w = dataset[time_idx]
    d = np.asarray(depth, np.float32)
    if d.ndim == 3:
        d = d[..., 0]
    gt_color = torch.as_tensor(np.asarray(color, np.float32) / np.float32(255),
                               device=device)
    return gt_color, torch.as_tensor(d, device=device), c2w


def apply_run_state(arrays: dict, meta: dict, frontend, backend,
                    dataset) -> int:
    """Set ``frontend`` and ``backend`` (fresh objects) to a checkpoint's
    state; returns the frame index to continue from."""
    dev = frontend.device
    next_idx = int(meta["next_frame_idx"])
    frontend.map = _map_from(arrays, "frontend_map", dev)
    frontend.n_active_host = int(frontend.map.n_active)
    frontend.cur_lmid = int(meta["cur_lmid"])
    frontend.vel = np.asarray(meta["vel"], np.float32)
    frontend.avg_depth_l1 = float(meta["avg_depth_l1"])
    frontend.depth_l1_rec = list(meta["depth_l1_rec"])
    frontend.numpts_rec = list(meta["numpts_rec"])
    frontend.tracking_flag = bool(meta["tracking_flag"])

    # rebuild the live (uncut) submap: every frame keeps its image until
    # the cut, so reload them all from the dataset by time_idx
    frontend.local_frames = []
    for fm in meta.get("cur_frames", []):
        gt_color, gt_depth, c2w = _images(dataset, fm["time_idx"], dev)
        fr = Frame(time_idx=fm["time_idx"], gt_color=gt_color,
                   gt_depth=gt_depth, gt_w2c=np.linalg.inv(np.asarray(c2w)),
                   kfid=fm["kfid"], frame_type=fm["frame_type"], device=dev)
        fr.est_w2c = np.asarray(fm["w2c"], np.float32)
        fr.mapping_times = int(fm["mapping_times"])
        frontend.local_frames.append(fr)
    # the last frame is "last" for the next process_frame's velocity
    # model; a fresh pose optimizer starts per frame, so est_w2c is
    # enough (checkpoints are only written between frames)
    if frontend.local_frames:
        frontend.local_frames[-1].start_optimizer(
            frontend.local_frames[-1].est_w2c,
            frontend.sys.lcfg.enable_exposure)

    if backend is None or "backend_map/step" not in arrays:
        return next_idx
    # made on the backend's stream, which then owns the tensors' memory
    with backend.stream_context():
        _apply_backend(arrays, meta, backend, dataset)
    return next_idx


def _apply_backend(arrays: dict, meta: dict, backend, dataset) -> None:
    from ..models.submap import LocalMap

    bdev = backend.device
    backend.map = _map_from(arrays, "backend_map", bdev)
    backend.n_active_host = int(backend.map.n_active)
    backend.totalpts_rec = list(meta["totalpts_rec"])
    backend.ape_rec = list(meta["ape_rec"])
    backend._peak_hist = [int(x) for x in meta.get("peak_hist", [])]
    for i, lmm in enumerate(meta["localmaps"]):
        saved_idxs = [int(x) for x in lmm.get("saved_idxs", [])]
        frames = []
        for fidx, fm in enumerate(lmm["frames"]):
            gt_color = gt_depth = None
            if fidx in saved_idxs:
                # retained keyframes reload their images from the dataset
                # so backend refinement keeps working on restored submaps
                gt_color, gt_depth, _ = _images(dataset, fm["time_idx"], bdev)
            fr = Frame(time_idx=fm["time_idx"], gt_color=gt_color,
                       gt_depth=gt_depth,
                       gt_w2c=np.asarray(fm["gt_w2c"], np.float32),
                       kfid=fm["kfid"], frame_type=fm["frame_type"],
                       device=bdev)
            fr.est_w2c = np.asarray(fm["est_w2c"], np.float32)
            fr.est_exposure = tuple(fm.get("est_exposure", (1.0, 0.0)))
            frames.append(fr)
        lm = LocalMap(lmid=lmm["lmid"], frames=frames, map_params=None,
                      tracking_ok=lmm["tracking_ok"], saved_idxs=saved_idxs,
                      ref2f0=np.asarray(lmm["ref2f0"], np.float32))
        lm.mapping_times = int(lmm["mapping_times"])
        lm.map_desc = np.asarray(lmm["map_desc"], np.float32)
        tr = _subtree(arrays, f"transforms/{i}")
        if tr:
            lm.transform = _state_from(tr, POSE_FIELDS, PoseState, bdev)
        ex = _subtree(arrays, f"exposures/{i}")
        if ex:
            lm.exposure = _state_from(ex, EXPOSURE_FIELDS, ExposureState,
                                      bdev)
        backend.local_maps.add_localmap(lm)
    backend.cur_lmid = len(backend.local_maps) - 1


def restore_run_state(path: str, frontend, backend, dataset) -> int:
    """Rebuild frontend/backend state from a checkpoint; returns the
    frame index to continue from."""
    arrays, meta = read_run_state(path)
    return apply_run_state(arrays, meta, frontend, backend, dataset)
