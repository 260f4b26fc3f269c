"""Rasterizer backward: K2 and K5 (port of
gaus_slam_tpu/ops/pallas_backward.py).

Per-pair attribute gradients [ATTR_C, R] from the loss cotangents of the
tile-major render buffer. The first cotangent of the pixel state (vjp of
``compositing.finalize``) has a closed form, ``finalize_cotangents``; the
kernels form it themselves from the saved output and the loss cotangent.

K2 (``raster_backward_stash``) is the reverse sweep over each tile's
blocks from the forward's stash: on the card csrc/raster_backward.cu
(hand-derived vjp of composite_chunk), on the CPU
``raster_backward_stash_plain`` (``torch.autograd.grad`` of the plain
``composite_chunk`` per block in reverse).

K5 (``raster_backward``) is the backward of the reference render
backend, whose forward keeps no stash: per tile it first re-runs K1's
block walk (at most ``MAX_CHUNKS_PER_TILE`` blocks) into a scratch stash
laid out as K1's, then runs K2's reverse sweep over it. On the card the
two phases are two kernels of raster_backward.cu launched by one C call,
on the CPU ``raster_backward_plain``. Its forward (``composite_ref.render_tiles``)
has no per-tile cap, so a tile with more than 64k pairs would differ.

K2 takes ``compute_dtype`` as K1 does; "bf16" launches its bf16
instantiation (counted as ``raster_backward_stash_bf16``), whose
recompute repeats K1-bf16's roundings and whose vjp runs in float32 on
those bf16-rounded values (csrc/raster_backward.cu). K5, as in the JAX
package, takes no dtype.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .binning import TileGrid
from .compositing import ATTR_C, OUT_C, PixelState, composite_chunk
from .composite_ref import tile_pixel_coords
from .raster_forward import (CHUNK, STASH_C, _aligned, _check_inputs,
                             _default_ids, dtype_of, raster_forward_plain,
                             stash_offsets, stash_rows)

# Blocks K5's re-forward visits per tile at most (64k pairs), as the TPU
# kernel's on-chip stash held; csrc/raster_common.cuh has the same bound.
MAX_CHUNKS_PER_TILE = 512


def finalize_cotangents(saved_out, d_out, bg, *, use_sa: bool):
    """Closed-form vjp of ``compositing.finalize`` -> d_state
    [T, OUT_C, P] in PixelState field order."""
    dr, dg, db = d_out[:, 0], d_out[:, 1], d_out[:, 2]
    dD = d_out[:, 3]
    dA = d_out[:, 4]
    dn = d_out[:, 5:8]
    dmid = d_out[:, 8]
    ddist = d_out[:, 9]
    mm = saved_out[:, 8]
    if use_sa:
        # dist = D2 - 2*sg(mm)*D + sg(mm)^2 * (1 - T)
        d_D = dD - 2.0 * mm * ddist
        d_D2 = ddist
        d_dist = torch.zeros_like(ddist)
        d_T = bg[0] * dr + bg[1] * dg + bg[2] * db - dA - mm * mm * ddist
    else:
        d_D = dD
        d_D2 = torch.zeros_like(ddist)
        d_dist = ddist
        d_T = bg[0] * dr + bg[1] * dg + bg[2] * db - dA
    zero = torch.zeros_like(dD)
    rows = [d_T, zero, dr, dg, db, dn[:, 0], dn[:, 1], dn[:, 2],
            d_D, d_D2, zero, zero, d_dist, dmid, zero, zero]
    return torch.stack(rows, dim=1)


def _state_from_stash(rows: torch.Tensor) -> PixelState:
    """stash [n, STASH_C, P] -> PixelState with zeroed linear accumulators."""
    z = torch.zeros_like(rows[:, 0:1])
    return PixelState(
        T=rows[:, 0:1], done=rows[:, 1:2], r=z, g=z, b=z, nx=z, ny=z, nz=z,
        D=rows[:, 2:3], D2=rows[:, 3:4], M1=rows[:, 4:5], M2=rows[:, 5:6],
        dist=z, mm=rows[:, 6:7], n_contrib=z, med_contrib=z,
    )


def raster_backward_stash_plain(pair_attrs, tile_start, tile_stop, stash,
                                kexit, saved_out, d_out, *, grid: TileGrid,
                                use_sa=True, need_normal=True, tile_ids=None,
                                compute_dtype: str = "f32",
                                f32_vjp: bool = False):
    """Plain PyTorch version of K2: vjp of composite_chunk per block in
    reverse, block k of every tile with k < kexit in one batched call.
    ``f32_vjp`` (under "bf16"): differentiate in float32 on the rounded
    forward values, as K2-bf16 does, instead of through bf16 tensors
    (composite_chunk)."""
    cdt = dtype_of(compute_dtype)
    r = _check_inputs(pair_attrs, grid)
    dev = pair_attrs.device
    ids = _default_ids(grid, tile_ids, dev)
    bg = torch.zeros(3, device=dev)
    d0 = finalize_cotangents(saved_out, d_out, bg, use_sa=use_sa)
    d_state = [d0[:, i:i + 1] for i in range(len(PixelState._fields))]
    start = tile_start.long()
    stop = tile_stop.long()
    blk0 = start // CHUNK
    soff = stash_offsets(tile_start, tile_stop).long()
    kex = kexit.long()
    px, py = tile_pixel_coords(grid, ids)
    blocks = pair_attrs.detach().T.reshape(r // CHUNK, CHUNK, ATTR_C)
    d_blocks = torch.zeros_like(blocks)
    ar = torch.arange(CHUNK, device=dev)
    n_steps = int(kex.max()) if kex.numel() else 0
    for k in reversed(range(n_steps)):
        idx = torch.nonzero(k < kex)[:, 0]
        b = blk0[idx] + k
        gi = b[:, None] * CHUNK + ar
        valid = ((gi >= start[idx, None]) & (gi < stop[idx, None]))
        idx_base = (b * CHUNK - start[idx] + 1)[:, None, None]
        state_in = PixelState(*(f.clone().requires_grad_()
                                for f in _state_from_stash(stash[soff[idx] + k])))
        attrs = blocks[b].clone().requires_grad_()
        with torch.enable_grad():
            new = composite_chunk(state_in, attrs, px[idx], py[idx], idx_base,
                                  valid[..., None].float(), use_sa=use_sa,
                                  need_normal=need_normal, dtype=cdt,
                                  f32_vjp=f32_vjp)
            outs, gouts = [], []
            for f, gf in zip(new, d_state):
                if f.requires_grad:
                    outs.append(f)
                    gouts.append(gf[idx])
            grads = torch.autograd.grad(outs, list(state_in) + [attrs],
                                        gouts, allow_unused=True)
        for fi in range(len(d_state)):
            gf = grads[fi]
            d_state[fi] = torch.index_put(
                d_state[fi], (idx,),
                torch.zeros_like(d_state[fi][idx]) if gf is None else gf)
        d_blocks.index_add_(0, b, grads[-1])
    return d_blocks.reshape(r, ATTR_C).T.contiguous()


def raster_backward_stash(pair_attrs, tile_start, tile_stop, stash, kexit,
                          saved_out, d_out, *, grid: TileGrid, use_sa=True,
                          need_normal=True, tile_ids=None,
                          compute_dtype: str = "f32"):
    """K2: d_attrs [ATTR_C, R]; rows of blocks no tile swept are 0."""
    if not pair_attrs.is_cuda:
        return raster_backward_stash_plain(
            pair_attrs, tile_start, tile_stop, stash, kexit, saved_out, d_out,
            grid=grid, use_sa=use_sa, need_normal=need_normal,
            tile_ids=tile_ids, compute_dtype=compute_dtype)
    bf16 = dtype_of(compute_dtype) == torch.bfloat16
    r = _check_inputs(pair_attrs, grid)
    dev = pair_attrs.device
    ids = _default_ids(grid, tile_ids, dev).contiguous()
    n_sub = ids.shape[0]
    attrs = pair_attrs.detach().contiguous()
    ts = tile_start.to(torch.int32).contiguous()
    te = tile_stop.to(torch.int32).contiguous()
    soff = stash_offsets(ts, te).contiguous()
    kex = kexit.to(torch.int32).contiguous()
    stash = stash.contiguous()
    out, dout = _out_rows(saved_out, d_out, n_sub, grid)
    for t, what in ((attrs, torch.float32), (ids, torch.int32),
                    (ts, torch.int32), (te, torch.int32), (kex, torch.int32),
                    (stash, torch.float32), (out, torch.float32),
                    (dout, torch.float32)):
        _cuda.require(t, what, "raster_backward")
    d_attrs = torch.zeros((ATTR_C, r), dtype=torch.float32, device=dev)
    fn = _cuda.library("raster_backward").raster_backward
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    name = "raster_backward_stash" + ("_bf16" if bf16 else "")
    _cuda.LAUNCHES[name] += 1
    _cuda.check(fn(_cuda.ptr(attrs), r, _cuda.ptr(ids), _cuda.ptr(ts),
                   _cuda.ptr(te), _cuda.ptr(soff), _cuda.ptr(kex),
                   _cuda.ptr(stash), stash.shape[0], _cuda.ptr(out),
                   _cuda.ptr(dout), n_sub, grid.tiles_x, int(use_sa),
                   int(need_normal), int(bf16), _cuda.ptr(d_attrs),
                   _cuda.stream()), name)
    return d_attrs


def _out_rows(saved_out, d_out, n, grid):
    """The forward's output and the loss cotangent as the kernels read
    them (contiguous float32 [n, OUT_C, P]): they form the first
    cotangent themselves (finalize_cotangents' closed form,
    raster_common.cuh::cot_from_out)."""
    shape = (n, OUT_C, grid.pixels_per_tile)
    out = saved_out.detach().float().contiguous()
    dout = d_out.float().contiguous()
    if tuple(out.shape) != shape or tuple(dout.shape) != shape:
        raise ValueError(f"saved_out and d_out must be {shape}, got "
                         f"{tuple(out.shape)} and {tuple(dout.shape)}")
    return out, dout


def raster_backward_plain(pair_attrs, tile_start, tile_stop, saved_out, d_out,
                          *, grid: TileGrid, use_sa=True, need_normal=True):
    """Plain PyTorch version of K5: the plain K1 walk capped at
    MAX_CHUNKS_PER_TILE blocks, then the plain K2 sweep over its stash.
    All tiles of the grid."""
    kw = dict(grid=grid, use_sa=use_sa, need_normal=need_normal)
    _, stash, kexit = raster_forward_plain(
        pair_attrs.detach(), tile_start, tile_stop,
        max_blocks=MAX_CHUNKS_PER_TILE, **kw)
    return raster_backward_stash_plain(pair_attrs, tile_start, tile_stop,
                                       stash, kexit, saved_out, d_out, **kw)


def raster_backward(pair_attrs, tile_start, tile_stop, saved_out, d_out, *,
                    grid: TileGrid, use_sa=True, need_normal=True,
                    scratch: torch.Tensor | None = None):
    """K5: d_attrs [ATTR_C, R] for the rows of every tile of the grid;
    ``saved_out`` is the forward's output (SA's cotangent reads its
    median). The scratch stash costs the same bytes as K1's; a caller may
    pass its own (float32 [stash_rows(R, T), STASH_C, P] on the card),
    which then holds the re-forward's stash in K1's layout (rows past a
    tile's kexit untouched)."""
    if not pair_attrs.is_cuda:
        return raster_backward_plain(pair_attrs, tile_start, tile_stop,
                                     saved_out, d_out, grid=grid,
                                     use_sa=use_sa, need_normal=need_normal)
    r = _check_inputs(pair_attrs, grid)
    dev = pair_attrs.device
    n = grid.num_tiles
    if tile_start.shape != (n,) or tile_stop.shape != (n,):
        raise ValueError(f"raster_backward takes the ranges of all {n} "
                         f"tiles, got {tuple(tile_start.shape)}")
    attrs = _aligned(pair_attrs.detach().contiguous())
    ts = tile_start.to(torch.int32).contiguous()
    te = tile_stop.to(torch.int32).contiguous()
    soff = stash_offsets(ts, te).contiguous()
    n_rows = stash_rows(r, n)
    shape = (n_rows, STASH_C, grid.pixels_per_tile)
    if scratch is None:
        scratch = torch.empty(shape, dtype=torch.float32, device=dev)
    elif tuple(scratch.shape) != shape:
        raise ValueError(f"scratch must be {shape}, got "
                         f"{tuple(scratch.shape)}")
    out, dout = _out_rows(saved_out, d_out, n, grid)
    for t, what in ((attrs, torch.float32), (ts, torch.int32),
                    (te, torch.int32), (out, torch.float32),
                    (dout, torch.float32), (scratch, torch.float32)):
        _cuda.require(t, what, "raster_backward")
    # the re-forward's kexit and tile ids, which the sweep reads
    kexit_ids = torch.empty((2, n), dtype=torch.int32, device=dev)
    d_attrs = torch.zeros((ATTR_C, r), dtype=torch.float32, device=dev)
    fn = _cuda.library("raster_backward").raster_backward_restash
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    _cuda.LAUNCHES["raster_backward"] += 1
    _cuda.check(fn(_cuda.ptr(attrs), r, _cuda.ptr(ts), _cuda.ptr(te),
                   _cuda.ptr(soff), _cuda.ptr(scratch), n_rows,
                   _cuda.ptr(kexit_ids[0]), _cuda.ptr(kexit_ids[1]),
                   _cuda.ptr(out), _cuda.ptr(dout), n, grid.tiles_x,
                   int(use_sa), int(need_normal), _cuda.ptr(d_attrs),
                   _cuda.stream()), "raster_backward")
    return d_attrs
