"""Monotone row gather — K4 (port of gaus_slam_tpu/ops/gather.py).

``out[i] = data[pos[i]]`` for a monotone non-decreasing ``pos`` with
steps <= ``max_step``. The JAX package needed a banded DMA + one-hot
matmul Pallas kernel because the TPU's row gather was latency-bound, and
took the data transposed ([C, R], the TPU's lanes on R). On the card the
kernel (csrc/gather.cu) gathers whole rows of the [R, C] layout the
gradient reduction holds: ``monotone_row_gather_rows``, which
``binning._land`` calls. ``monotone_row_gather`` keeps the JAX contract
([C, R] -> [C, N]) on top of it. A position outside [0, R) gives a row of
NaN. The VMEM bound ``GATHER_N_MAX`` of the TPU version does not exist
here. Bit-exact: it only moves floats.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda


def monotone_row_gather_rows_plain(data: torch.Tensor,
                                   pos: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [R, C] -> [N, C] = data[pos], NaN rows
    where pos is outside [0, R)."""
    r = data.shape[0]
    pos = pos.long()
    ok = (pos >= 0) & (pos < r)
    if r == 0:
        return torch.full((pos.shape[0],) + data.shape[1:], float("nan"),
                          dtype=data.dtype, device=data.device)
    rows = data[torch.clamp(pos, 0, r - 1)]
    return torch.where(ok[:, None], rows, torch.full_like(rows, float("nan")))


def monotone_row_gather_rows(data: torch.Tensor,
                             pos: torch.Tensor) -> torch.Tensor:
    """K4: [R, C] f32, [N] int -> [N, C] = data[pos] (NaN rows where pos
    is outside [0, R)). On a CUDA tensor the kernel, on the CPU the plain
    version."""
    if not data.is_cuda:
        return monotone_row_gather_rows_plain(data, pos)
    data = data.contiguous()
    pos = pos.to(torch.int32).contiguous()
    _cuda.require(data, torch.float32, "monotone_row_gather data")
    _cuda.require(pos, torch.int32, "monotone_row_gather pos")
    r, c = data.shape
    (n,) = pos.shape
    out = torch.empty((n, c), dtype=torch.float32, device=data.device)
    if out.numel() == 0:
        return out
    fn = _cuda.library("gather").monotone_row_gather_rows
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _cuda.LAUNCHES["monotone_row_gather"] += 1
    _cuda.check(fn(_cuda.ptr(data), _cuda.ptr(pos), _cuda.ptr(out),
                   r, n, c, _cuda.stream()), "monotone_row_gather")
    return out


def monotone_row_gather_plain(data_t: torch.Tensor,
                              pos: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the JAX contract: [C, R] -> [C, N]."""
    return monotone_row_gather_rows_plain(data_t.T, pos).T


def monotone_row_gather(data_t: torch.Tensor, pos: torch.Tensor, *,
                        max_step: int) -> torch.Tensor:
    """The JAX contract: [C, R] f32, [N] int32 -> [C, N] = data_t[:, pos]
    (a transposed view of the row kernel's result). ``max_step`` states
    the monotone step bound of ``pos`` (the gradient reduction's d_max);
    the CUDA kernel does not rely on it."""
    del max_step
    return monotone_row_gather_rows(data_t.T, pos).T
