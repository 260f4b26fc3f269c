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
attribute names, so a test can set both frontends to the same state;
``backend_state_from_jax`` does the same for a JAX ``Backend``, and
``localmap_from_jax`` converts one JAX ``LocalMap``.

``run_state_from_jax`` carries a JAX checkpoint (the orbax tree that the
JAX ``restore_run_state`` reads back, and its meta.json) into the port's
checkpoint layout, for ``utils.checkpoint.apply_run_state``.
"""
from __future__ import annotations

import collections
import dataclasses
import random

import numpy as np
import torch

from .models.frame import ExposureState, Frame, PoseState
from .models.gaussians import PARAM_FIELDS, GaussianMap, Params
from .models.submap import LocalMap, Localmaps
from .render import PairCache
from .utils.config import SystemConfig

POSE_FIELDS = ("quat", "trans", "m_q", "v_q", "m_t", "v_t")


def _step(x, device) -> torch.Tensor:
    """An Adam step count as the port keeps it: a device int32 scalar."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return torch.as_tensor(np.array(x, np.int32).reshape(()), device=device)


def _host_step(x) -> np.int32:
    """A step count (a device scalar, or a number) on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.int32(np.asarray(x))


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
        step=_step(d["step"], device),
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
        "step": _host_step(gm.step),
        "active": gm.active.cpu().numpy(),
        "n_active": np.int32(int(gm.n_active)),
    }


def pose_from_numpy(d, device="cuda") -> PoseState:
    if hasattr(d, "_asdict"):
        d = d._asdict()
    vals = [torch.as_tensor(np.array(d[f], np.float32), device=device)
            for f in POSE_FIELDS]
    return PoseState(*vals, _step(d["step"], device))


def pose_to_numpy(ps: PoseState) -> dict:
    out = {f: getattr(ps, f).detach().cpu().numpy() for f in POSE_FIELDS}
    out["step"] = _host_step(ps.step)
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
            _tensor(e.m, device), _tensor(e.v, device), _step(e.step, device))
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
        "rng": _rng_copy(jf.rng),
        "sys": _sys_from(jf.config, jf.sys, "frontend", device),
        "_spec": spec,
    }


def _rng_copy(rng) -> random.Random:
    out = random.Random()
    out.setstate(rng.getstate())
    return out


def _sys_from(config, jsys, component, device) -> SystemConfig:
    """The port's SystemConfig for ``config`` with the (possibly
    escalated) pair budgets of the JAX one."""
    sys = SystemConfig.from_config(config, backend=jsys.opts.backend,
                                   component=component, device=device)
    jo = jsys.opts
    return dataclasses.replace(sys, opts=sys.opts._replace(
        pair_budget_factor=jo.pair_budget_factor, pair_cap=jo.pair_cap,
        max_tiles_per_gaussian=jo.max_tiles_per_gaussian))


def _exposure_from(e, device) -> ExposureState | None:
    if e is None:
        return None
    return ExposureState(_tensor(e.gain, device), _tensor(e.bias, device),
                         _tensor(e.m, device), _tensor(e.v, device),
                         _step(e.step, device))


def localmap_from_jax(lm, device="cuda") -> LocalMap:
    """A JAX LocalMap as the port's: frames (frozen poses, kept images),
    the donor snapshot (if not yet merged), descriptor, transform and
    exposure (if started), mapping_times and the host count."""
    device = torch.device(device)
    snap = None
    if lm.map_params is not None:
        params, active, n_active = lm.map_params
        snap = (_params(params, device),
                torch.as_tensor(np.array(active, bool), device=device),
                torch.as_tensor(np.array(n_active, np.int32), device=device))
    return LocalMap(
        lmid=int(lm.lmid), frames=[_frame_from(f, device) for f in lm.frames],
        map_params=snap, tracking_ok=bool(lm.tracking_ok),
        saved_idxs=list(lm.saved_idxs),
        ref2f0=None if lm.ref2f0 is None else np.array(lm.ref2f0),
        transform=(None if lm.transform is None
                   else pose_from_numpy(lm.transform, device)),
        exposure=_exposure_from(lm.exposure, device),
        map_desc=None if lm.map_desc is None else np.array(lm.map_desc),
        mapping_times=int(lm.mapping_times),
        n_active_host=(None if lm.n_active_host is None
                       else int(lm.n_active_host)))


def backend_state_from_jax(jb, device="cuda") -> dict:
    """The state of the JAX Backend ``jb`` as the port Backend's
    attributes (``vars(backend).update(...)``): the global map, the
    LocalMaps with their transforms and descriptor matrix, ``cur_lmid``,
    ``n_active_host``, ``_peak_hist``, the RNG state, the task queue, the
    covisible submaps, the coarse-phase counters, the (possibly escalated)
    pair budgets in ``sys``, the exposure placeholder and the records."""
    device = torch.device(device)
    lms = Localmaps()
    for lm in jb.local_maps:
        lms.add_localmap(localmap_from_jax(lm, device))
    return {
        "map": None if jb.map is None else _map_from(jb.map, device),
        "local_maps": lms,
        "cur_lmid": int(jb.cur_lmid),
        "n_active_host": int(jb.n_active_host),
        "_peak_hist": [int(p) for p in jb._peak_hist],
        "bucket_flips": int(getattr(jb, "bucket_flips", 0)),
        "rng": _rng_copy(jb.rng),
        "task_queue": collections.deque(
            tuple(t) for t in list(jb.task_queue.queue)),
        "covis_idxs": [int(i) for i in jb.covis_idxs],
        "_map_phase": int(jb._map_phase),
        "_map_phase_pre": int(jb._map_phase_pre),
        "sys": _sys_from(jb.config, jb.sys, "backend", device),
        "exposure": _exposure_from(jb.exposure, device),
        "ape_rec": list(jb.ape_rec),
        "totalpts_rec": [int(n) for n in jb.totalpts_rec],
    }


def run_state_from_jax(state: dict, meta: dict) -> tuple[dict, dict]:
    """(arrays, meta) of the port's checkpoint from a JAX run state: the
    nested tree of a JAX checkpoint's arrays (``frontend_map``,
    ``backend_map``, ``transforms``, ``exposures``; any array type that
    numpy reads) and its meta.json, whose schema the port shares."""
    from .utils.checkpoint import _flatten

    return _flatten(state), dict(meta)
