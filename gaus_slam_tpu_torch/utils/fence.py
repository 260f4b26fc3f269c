"""Device fence for timing between two points (the port's counterpart of
gaus_slam_tpu/utils/fence.py).

On a CUDA device the fence is ``torch.cuda.synchronize`` on it; on the
CPU there is nothing to wait for.
"""
from __future__ import annotations

import torch


def device_fence(device) -> None:
    """Wait until every kernel queued on ``device`` has finished; nothing
    to wait for on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
