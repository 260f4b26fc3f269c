"""Carry map and pose state across as numpy.

``gaussian_map_from_numpy`` takes the fields of a GaussianMap as numpy
arrays — ``params``, ``m``, ``v`` (each a mapping or sequence of the five
parameter arrays xyz, log_scales, quats, opacity_logit, rgb), ``step``,
``active``, ``n_active`` — and builds the port's map on ``device``;
``gaussian_map_to_numpy`` is its inverse. ``pose_from_numpy`` /
``pose_to_numpy`` do the same for PoseState (quat, trans, m_q, v_q, m_t,
v_t, step). The JAX package's NamedTuples convert with the same field
names, so tests feed both packages the same map and pose this way.

``frontend_state_from_jax`` reads a JAX ``Frontend`` (through numpy
only) and returns the port ``Frontend``'s state as a dict keyed by its
attribute names, so a test can set both frontends to the same state.
"""
from __future__ import annotations

import dataclasses
import random

import numpy as np
import torch

from .models.frame import ExposureState, Frame, PoseState
from .models.gaussians import PARAM_FIELDS, GaussianMap, Params
from .render import PairCache
from .utils.config import SystemConfig

POSE_FIELDS = ("quat", "trans", "m_q", "v_q", "m_t", "v_t")


def _params(x, device) -> Params:
    if hasattr(x, "_asdict"):
        x = x._asdict()
    vals = [x[f] for f in PARAM_FIELDS] if isinstance(x, dict) else list(x)
    return Params(*(torch.as_tensor(np.array(v, np.float32), device=device)
                    for v in vals))


def gaussian_map_from_numpy(d, device="cuda") -> GaussianMap:
    if hasattr(d, "_asdict"):
        d = d._asdict()
    return GaussianMap(
        params=_params(d["params"], device),
        m=_params(d["m"], device),
        v=_params(d["v"], device),
        step=int(np.asarray(d["step"])),
        active=torch.as_tensor(np.array(d["active"], bool), device=device),
        n_active=torch.as_tensor(np.array(d["n_active"], np.int32),
                                 device=device),
    )


def _np_params(p: Params) -> dict:
    return {f: v.detach().cpu().numpy() for f, v in zip(PARAM_FIELDS, p)}


def gaussian_map_to_numpy(gm: GaussianMap) -> dict:
    return {
        "params": _np_params(gm.params),
        "m": _np_params(gm.m),
        "v": _np_params(gm.v),
        "step": np.int32(gm.step),
        "active": gm.active.cpu().numpy(),
        "n_active": np.int32(int(gm.n_active)),
    }


def pose_from_numpy(d, device="cuda") -> PoseState:
    if hasattr(d, "_asdict"):
        d = d._asdict()
    vals = [torch.as_tensor(np.array(d[f], np.float32), device=device)
            for f in POSE_FIELDS]
    return PoseState(*vals, int(np.asarray(d["step"])))


def pose_to_numpy(ps: PoseState) -> dict:
    out = {f: getattr(ps, f).detach().cpu().numpy() for f in POSE_FIELDS}
    out["step"] = np.int32(ps.step)
    return out


def _map_from(gm, device) -> GaussianMap:
    return gaussian_map_from_numpy(
        {"params": gm.params, "m": gm.m, "v": gm.v, "step": gm.step,
         "active": gm.active, "n_active": gm.n_active}, device=device)


def _tensor(x, device, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def _frame_from(f, device) -> Frame:
    out = Frame(
        time_idx=f.time_idx,
        gt_color=None if f.gt_color is None else _tensor(f.gt_color, device),
        gt_depth=None if f.gt_depth is None else _tensor(f.gt_depth, device),
        gt_w2c=np.array(f.gt_w2c), kfid=f.kfid, frame_type=f.frame_type,
        pose=None if f.pose is None else pose_from_numpy(f.pose, device),
        est_w2c=np.array(f.est_w2c), est_exposure=tuple(f.est_exposure),
        mapping_times=int(f.mapping_times), device=device)
    if f.exposure is not None:
        e = f.exposure
        out.exposure = ExposureState(
            _tensor(e.gain, device), _tensor(e.bias, device),
            _tensor(e.m, device), _tensor(e.v, device), int(np.asarray(e.step)))
    if getattr(f, "_w2c_host", None) is not None:
        out._w2c_host = np.array(f._w2c_host)
    return out


def frontend_state_from_jax(jf, device="cuda") -> dict:
    """The state of the JAX Frontend ``jf`` as the port Frontend's
    attributes: the map, the local frames (poses, images, mapping_times),
    ``vel``, ``avg_depth_l1``, ``tracking_flag``, ``cur_lmid``,
    ``n_active_host``, the RNG state, the (possibly escalated) pair budgets
    in ``sys`` and a pending speculative binning ``_spec``."""
    device = torch.device(device)
    gm = _map_from(jf.map, device)
    sys = SystemConfig.from_config(jf.config, backend=jf.sys.opts.backend,
                                   component="frontend", device=device)
    jo = jf.sys.opts
    sys = dataclasses.replace(sys, opts=sys.opts._replace(
        pair_budget_factor=jo.pair_budget_factor, pair_cap=jo.pair_cap,
        max_tiles_per_gaussian=jo.max_tiles_per_gaussian))
    rng = random.Random()
    rng.setstate(jf.rng.getstate())
    spec = None
    if jf._spec is not None and jf._spec[0] is jf.map:
        _, cache, pose, w2c = jf._spec
        spec = (gm, PairCache(
            raw_t=_tensor(cache.raw_t, device),
            tile_start=_tensor(cache.tile_start, device, torch.int32),
            tile_stop=_tensor(cache.tile_stop, device, torch.int32),
            num_pairs=_tensor(cache.num_pairs, device, torch.int32),
            overflow=_tensor(cache.overflow, device, torch.bool),
            n_shrunk=_tensor(cache.n_shrunk, device, torch.int32),
            demand=_tensor(cache.demand, device, torch.int32)),
            pose_from_numpy(pose, device), np.array(w2c))
    return {
        "map": gm,
        "local_frames": [_frame_from(f, device) for f in jf.local_frames],
        "vel": np.array(jf.vel, np.float32),
        "avg_depth_l1": float(jf.avg_depth_l1),
        "tracking_flag": bool(jf.tracking_flag),
        "cur_lmid": int(jf.cur_lmid),
        "n_active_host": int(jf.n_active_host),
        "rng": rng,
        "sys": sys,
        "_spec": spec,
    }
