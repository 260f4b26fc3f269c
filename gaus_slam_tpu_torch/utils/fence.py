"""Device fence for profiling marks (port of gaus_slam_tpu/utils/fence.py).

On a CUDA tensor (or device) the fence is ``torch.cuda.synchronize`` on
its device; on the CPU there is nothing to wait for.
"""
from __future__ import annotations

import torch


def probe_fence(x: torch.Tensor) -> float:
    """Wait for the device work queue; returns ``float(x.ravel()[0])``."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(x.reshape(-1)[0])


def device_fence(device) -> None:
    """Wait until every kernel queued on ``device`` has finished; nothing
    to wait for on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
