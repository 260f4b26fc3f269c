"""Frame staging in native camera dtypes (port of
gaus_slam_tpu/utils/stage.py).

Cameras produce uint8 colour and uint16 depth (the reference's datasets
store depth PNGs at Replica's 6553.5 counts per metre). The pipelined
driver ships frames to the card in those dtypes, 2 bytes a depth pixel
and 1 a colour channel instead of 4, and the frontend dequantizes them
on its device.

For integer-valued sources (every real dataset) the colour path is
lossless. For the procedural synthetic scene it applies the same
quantization a real capture would (0.15 mm depth LSB, 1/255 colour).
"""
from __future__ import annotations

import numpy as np

# Replica's depth PNG convention: 6553.5 counts per meter -> 0.153 mm
# LSB, 10 m ceiling (reference configs/data/replica.yaml).
DEPTH_U16_SCALE = 6553.5
_DEPTH_MAX_M = 65535.0 / DEPTH_U16_SCALE


def pack_frame(color, depth):
    """Quantize one RGB-D frame to transfer dtypes.

    color: [H, W, 3] in 0..255 (any float/int dtype) -> uint8.
    depth: [H, W(,1)] meters -> uint16 at DEPTH_U16_SCALE, or float32
    unchanged when the scene exceeds the 10 m uint16 ceiling (the
    frontend accepts either dtype).
    """
    c8 = np.clip(np.round(np.asarray(color, np.float32)), 0, 255)
    c8 = c8.astype(np.uint8)
    d = np.asarray(depth, np.float32)
    if float(d.max(initial=0.0)) <= _DEPTH_MAX_M:
        d = np.round(d * np.float32(DEPTH_U16_SCALE)).astype(np.uint16)
    return c8, d
