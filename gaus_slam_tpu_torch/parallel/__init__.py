"""Keyframe-parallel bundle adjustment over a group of devices (port of
gaus_slam_tpu/parallel/)."""
from __future__ import annotations

import torch

from .ba import make_devices, sharded_ba_step  # noqa: F401


def devices_from_config(config: dict, device="cuda", n_avail=None):
    """The backend's BA group from ``config['tpu']['mesh_devices']`` (the
    counterpart of the JAX package's ``mesh_from_config``).

    Values: "auto" (default: every attached device when more than one
    exists), an int N (the first N devices; ValueError if fewer are
    attached), or 0/1/"off" (no group). Returns a list of torch.devices
    or None. The attached count is ``torch.cuda.device_count()`` on
    ``cuda`` and 1 on the CPU; ``n_avail`` overrides it.
    """
    device = torch.device(device)
    md = config.get("tpu", {}).get("mesh_devices", "auto")
    if n_avail is None:
        n_avail = torch.cuda.device_count() if device.type == "cuda" else 1
    if md in ("off", 0, 1, "0", "1", None, False):
        return None
    if md == "auto":
        n = n_avail
    else:
        n = int(md)
        if n > n_avail:
            raise ValueError(
                f"tpu.mesh_devices={n} but only {n_avail} devices attached")
    if n <= 1:
        return None
    return make_devices(n, device)
