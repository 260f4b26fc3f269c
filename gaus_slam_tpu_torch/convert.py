"""Carry map and pose state across as numpy.

``gaussian_map_from_numpy`` takes the fields of a GaussianMap as numpy
arrays — ``params``, ``m``, ``v`` (each a mapping or sequence of the five
parameter arrays xyz, log_scales, quats, opacity_logit, rgb), ``step``,
``active``, ``n_active`` — and builds the port's map on ``device``;
``gaussian_map_to_numpy`` is its inverse. ``pose_from_numpy`` /
``pose_to_numpy`` do the same for PoseState (quat, trans, m_q, v_q, m_t,
v_t, step). The JAX package's NamedTuples convert with the same field
names, so tests feed both packages the same map and pose this way.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.frame import PoseState
from .models.gaussians import PARAM_FIELDS, GaussianMap, Params

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
