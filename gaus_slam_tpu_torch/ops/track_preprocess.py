"""The tracking render's per-pair preprocess: the frozen pair cache moved
by the live pose into the [PAIR_C, R] pair attributes, with its backward
down to the pose gradient.

No TPU kernel: in the JAX package ``render_tracking`` runs this as plain
JAX (the cache's means through the pose, the quaternions through its
rotation, then ``preprocess_t`` with an identity camera), which XLA
fuses. In PyTorch that chain is ~320 elementwise kernels forward and
~190 backward, each streaming a row of R floats, so on the card it is
one ``autograd.Function`` of two hand-written kernels
(csrc/track_preprocess.cu): K7 (``track_preprocess``) writes the 24 rows
in one pass, K8 (``track_preprocess_backward``) reduces the pair
attributes' gradient to d_w2c, deterministically (block partials, then
one block sums them in order). ``pose_matrix``, the ``pre_w2c``
composition and the pose Adam stay in PyTorch: autograd carries d_w2c
back to the quaternion and the translation.

On the CPU ``track_preprocess`` is the chain itself
(``track_preprocess_plain``), autograd and all.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .camera import Camera, world_to_pix3
from .preprocess import PAIR_C, preprocess_t
from .se3 import quat_multiply_rows


def track_preprocess_plain(raw_t, w2c, q, cam_eye: Camera) -> torch.Tensor:
    """The pair cache ``raw_t`` [13, R] (xyz | scales | quats | opac | rgb
    rows) moved by ``w2c`` [4, 4] (live: the gradient flows through the
    means) and the detached rotation ``q`` [4], then ``preprocess_t`` with
    ``cam_eye`` (the projection at the identity pose): [PAIR_C, R]."""
    xyz_cam_t = w2c[:3, :3] @ raw_t[0:3] + w2c[:3, 3][:, None]
    quats_cam_t = quat_multiply_rows(q, raw_t[5:9]).detach()
    attrs, _ = preprocess_t(xyz_cam_t, raw_t[3:5], quats_cam_t, raw_t[9],
                            raw_t[10:13], cam_eye)
    return attrs


def _rows(t: torch.Tensor, n_rows: int, what: str) -> int:
    """The row stride of a float32 CUDA [>= n_rows, R] tensor whose rows
    are contiguous."""
    if (not t.is_cuda or t.dtype != torch.float32 or t.dim() != 2
            or t.shape[0] < n_rows or (t.shape[1] > 1 and t.stride(1) != 1)):
        raise ValueError(f"{what}: expected a float32 CUDA [>= {n_rows}, R] "
                         f"tensor with contiguous rows, got {t.dtype} "
                         f"{tuple(t.shape)} strides {t.stride()} on "
                         f"{t.device}")
    return t.stride(0)


def _small(t: torch.Tensor, shape: tuple, what: str) -> torch.Tensor:
    t = t.detach().contiguous()
    _cuda.require(t, torch.float32, what)
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} must be {shape}, got {tuple(t.shape)}")
    return t


def k7(raw_t, w2c, q, M) -> torch.Tensor:
    """K7: [PAIR_C, R] pair attributes of ``raw_t`` (float32 CUDA [>= 13,
    R], rows contiguous: a head slice of a cache is read where it lies)
    at ``w2c`` [4, 4] and ``q`` [4], with the pixel map ``M`` [3, 4]."""
    ld = _rows(raw_t, 13, "track_preprocess raw_t")
    n = raw_t.shape[1]
    w2c = _small(w2c, (4, 4), "track_preprocess w2c")
    q = _small(q, (4,), "track_preprocess q")
    M = _small(M, (3, 4), "track_preprocess M")
    out = torch.empty((PAIR_C, n), dtype=torch.float32, device=raw_t.device)
    fn = _cuda.library("track_preprocess").track_preprocess
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    _cuda.LAUNCHES["track_preprocess"] += 1
    _cuda.check(fn(_cuda.ptr(raw_t), ld, n, _cuda.ptr(w2c), _cuda.ptr(q),
                   _cuda.ptr(M), _cuda.ptr(out), _cuda.stream()),
                "track_preprocess")
    return out


def k8(raw_t, q, M, d_attrs) -> torch.Tensor:
    """K8: d_w2c [4, 4] from the pair attributes' gradient ``d_attrs``
    (float32 CUDA [>= 12, R]); the same inputs give the same bits."""
    ld = _rows(raw_t, 13, "track_preprocess raw_t")
    n = raw_t.shape[1]
    q = _small(q, (4,), "track_preprocess q")
    M = _small(M, (3, 4), "track_preprocess M")
    if d_attrs.shape[1] != n or (n > 1 and d_attrs.stride(1) != 1):
        d_attrs = d_attrs.contiguous()
    ld_d = _rows(d_attrs, 12, "track_preprocess_backward d_attrs")
    lib = _cuda.library("track_preprocess")
    lib.track_preprocess_blocks.argtypes = [ctypes.c_int]
    lib.track_preprocess_blocks.restype = ctypes.c_int
    partials = torch.empty((lib.track_preprocess_blocks(n), 12),
                           dtype=torch.float32, device=raw_t.device)
    d_w2c = torch.empty((4, 4), dtype=torch.float32, device=raw_t.device)
    fn = lib.track_preprocess_backward
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int64]
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    _cuda.LAUNCHES["track_preprocess_backward"] += 1
    _cuda.check(fn(_cuda.ptr(raw_t), ld, n, _cuda.ptr(q), _cuda.ptr(M),
                   _cuda.ptr(d_attrs), ld_d, _cuda.ptr(partials),
                   _cuda.ptr(d_w2c), _cuda.stream()),
                "track_preprocess_backward")
    return d_w2c


class _TrackPreprocess(torch.autograd.Function):
    @staticmethod
    def forward(ctx, raw_t, w2c, q, M):
        ctx.save_for_backward(raw_t, q, M)
        return k7(raw_t, w2c, q, M)

    @staticmethod
    def backward(ctx, d_attrs):
        raw_t, q, M = ctx.saved_tensors
        return None, k8(raw_t, q, M, d_attrs), None, None


def track_preprocess(raw_t, w2c, q, cam_eye: Camera) -> torch.Tensor:
    """[PAIR_C, R] pair attributes of the pair cache ``raw_t`` (a [13, R]
    tensor or a head slice of one) at the pose ``w2c``; differentiable in
    ``w2c`` alone. K7 and K8 on the card, ``track_preprocess_plain`` on
    the CPU."""
    if not raw_t.is_cuda:
        return track_preprocess_plain(raw_t, w2c, q, cam_eye)
    return _TrackPreprocess.apply(raw_t, w2c, q.detach(),
                                  world_to_pix3(cam_eye))
