"""Device memory held in CUDA graph pools: a frozen copy of the port's
``tools/frame_split.py::pool_mib``."""
from __future__ import annotations

import torch


def pool_mib() -> float:
    """MiB the caching allocator holds in graph pools (segments of a
    private pool)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)) / 2**20
