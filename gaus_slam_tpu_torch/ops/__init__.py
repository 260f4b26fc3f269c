"""Rasterizer ops: camera, SE(3), preprocess, binning, compositing, kernels."""
