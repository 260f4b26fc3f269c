"""Monotone row gather — K4 (port of gaus_slam_tpu/ops/gather.py).

``out[:, i] = data_t[:, pos[i]]`` for a monotone non-decreasing ``pos``
with steps <= ``max_step``. The JAX package needed a banded DMA +
one-hot matmul Pallas kernel because the TPU's row gather was
latency-bound; on the card it is csrc/gather.cu (one thread per output
element). The VMEM bound ``GATHER_N_MAX`` of the TPU version does not
exist here. Bit-exact: it only moves floats.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda


def monotone_row_gather_plain(data_t: torch.Tensor,
                              pos: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [C, R] -> [C, N]."""
    return data_t[:, pos.long()]


def monotone_row_gather(data_t: torch.Tensor, pos: torch.Tensor, *,
                        max_step: int) -> torch.Tensor:
    """[C, R] f32, [N] int32 -> [C, N] = data_t[:, pos]. ``max_step``
    states the monotone step bound of ``pos`` (the gradient reduction's
    d_max); the CUDA kernel does not rely on it."""
    del max_step
    if not data_t.is_cuda:
        return monotone_row_gather_plain(data_t, pos)
    data_t = data_t.contiguous()
    pos = pos.to(torch.int32).contiguous()
    _cuda.require(data_t, torch.float32, "monotone_row_gather data_t")
    _cuda.require(pos, torch.int32, "monotone_row_gather pos")
    c, r = data_t.shape
    (n,) = pos.shape
    out = torch.empty((c, n), dtype=torch.float32, device=data_t.device)
    fn = _cuda.library("gather").monotone_row_gather
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _cuda.LAUNCHES["monotone_row_gather"] += 1
    _cuda.check(fn(_cuda.ptr(data_t), _cuda.ptr(pos), _cuda.ptr(out),
                   r, n, c, _cuda.stream()), "monotone_row_gather")
    return out
