"""Frame staging in native camera dtypes (the constant of
gaus_slam_tpu/utils/stage.py the frontend needs).

Cameras produce uint8 colour and uint16 depth (the reference's datasets
store depth PNGs at Replica's 6553.5 counts per metre); the frontend
accepts those dtypes and dequantizes them on its device.
"""
from __future__ import annotations

# Replica's depth PNG convention: 6553.5 counts per meter -> 0.153 mm
# LSB, 10 m ceiling (reference configs/data/replica.yaml).
DEPTH_U16_SCALE = 6553.5
