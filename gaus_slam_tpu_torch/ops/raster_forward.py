"""Rasterizer forward: K1 (with the per-block carry stash) and K3 (without)
(port of gaus_slam_tpu/ops/pallas_forward.py).

On the card: csrc/raster_forward.cu, one CTA per rendered tile. On the
CPU: ``raster_forward_plain``, which walks every tile's 128-aligned
global blocks through ``compositing.composite_chunk`` as ``_kernel_stash``
does — block k of all still-live tiles in one batched call — and fills
the stash and kexit the same way, honouring ``tile_ids``.

``compute_dtype`` ("f32" or "bf16", ``tpu.compute_dtype``) picks the
dtype of the per-pair chain (compositing.py's docstring lists where bf16
rounds); the stash, kexit and the output stay float32. On the card
"bf16" launches the kernels' bf16 instantiation, counted under names of
its own (``raster_forward_stash_bf16``, ``raster_forward_bf16``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .binning import TileGrid
from .composite_ref import tile_pixel_coords
from .compositing import ATTR_C, OUT_C, composite_chunk, finalize, init_state

CHUNK = 128
COMPUTE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# Rows of a stash entry: the block's incoming T, done, D, D2, M1, M2, mm,
# padded to 8.
STASH_C = 8


def stash_offsets(tile_start: torch.Tensor, tile_stop: torch.Tensor) -> torch.Tensor:
    """Per-tile row offsets into the block-carry stash: tile t owns rows
    [soff[t], soff[t] + nblk[t])."""
    nblk = torch.where(
        tile_stop > tile_start,
        (tile_stop + (CHUNK - 1)) // CHUNK - tile_start // CHUNK,
        torch.zeros_like(tile_stop),
    ).to(torch.int32)
    return (torch.cumsum(nblk, 0) - nblk).to(torch.int32)


def stash_rows(r: int, num_tiles: int) -> int:
    """Static bound on total stash rows: the tile ranges partition the
    pair array, so sum(nblk) <= r/CHUNK + one boundary block per tile."""
    return r // CHUNK + num_tiles


def dtype_of(compute_dtype: str) -> torch.dtype:
    """The torch dtype of a ``compute_dtype`` name; ValueError for any
    other name."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r}: one of "
                         f"{tuple(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[compute_dtype]


def _check_inputs(pair_attrs, grid):
    c, r = pair_attrs.shape
    if c != ATTR_C or r % CHUNK:
        raise ValueError(f"pair_attrs must be [{ATTR_C}, R] with R a "
                         f"multiple of {CHUNK}, got {tuple(pair_attrs.shape)}")
    if (grid.block_w, grid.block_h) != (16, 16):
        raise ValueError(f"the rasterizer takes 16x16 tiles, got {grid}")
    return r


def _aligned(attrs):
    """The slab as the forward walk copies it (16 bytes at a time, with
    cp.async): on a 16-byte boundary, copied there if its storage starts
    elsewhere."""
    return attrs if attrs.data_ptr() % 16 == 0 else attrs.clone()


def _default_ids(grid, tile_ids, device):
    if tile_ids is None:
        return torch.arange(grid.num_tiles, dtype=torch.int32, device=device)
    return tile_ids.to(torch.int32)


def _stack_stash(s):
    return torch.cat([s.T, s.done, s.D, s.D2, s.M1, s.M2, s.mm,
                      torch.zeros_like(s.T)], dim=-2)


def raster_forward_plain(pair_attrs, tile_start, tile_stop, *, grid: TileGrid,
                         use_sa=True, need_normal=True, tile_ids=None,
                         max_blocks: int | None = None,
                         compute_dtype: str = "f32"):
    """Plain PyTorch version of K1. Returns (out [n_sub, OUT_C, P],
    stash [S, STASH_C, P], kexit [n_sub] int32); K3's output is ``out``.
    ``max_blocks`` caps the blocks a tile walks (K5's re-forward)."""
    cdt = dtype_of(compute_dtype)
    r = _check_inputs(pair_attrs, grid)
    dev = pair_attrs.device
    ids = _default_ids(grid, tile_ids, dev)
    n_sub = ids.shape[0]
    P = grid.pixels_per_tile
    start = tile_start.long()
    stop = tile_stop.long()
    blk0 = start // CHUNK
    nblk = torch.where(stop > start, (stop + CHUNK - 1) // CHUNK - blk0,
                       torch.zeros_like(stop))
    if max_blocks is not None:
        nblk = torch.clamp(nblk, max=max_blocks)
    soff = stash_offsets(tile_start, tile_stop).long()
    px, py = tile_pixel_coords(grid, ids)
    blocks = pair_attrs.detach().T.reshape(r // CHUNK, CHUNK, ATTR_C)
    dt = pair_attrs.dtype
    stash = torch.zeros((stash_rows(r, n_sub), STASH_C, P), dtype=dt,
                        device=dev)
    kexit = torch.zeros((n_sub,), dtype=torch.int32, device=dev)
    state = init_state(P, (n_sub,), dev, dt)
    ar = torch.arange(CHUNK, device=dev)
    n_steps = int(nblk.max()) if n_sub else 0
    for k in range(n_steps):
        live = (k < nblk) & (state.done.amin(dim=(-2, -1)) < 0.5)
        idx = torch.nonzero(live)[:, 0]
        if idx.numel() == 0:
            break
        sub = type(state)(*(f[idx] for f in state))
        stash[soff[idx] + k] = _stack_stash(sub)
        b = blk0[idx] + k
        gi = b[:, None] * CHUNK + ar
        valid = ((gi >= start[idx, None]) & (gi < stop[idx, None]))
        idx_base = (b * CHUNK - start[idx] + 1)[:, None, None]
        new = composite_chunk(sub, blocks[b], px[idx], py[idx], idx_base,
                              valid[..., None].float(), use_sa=use_sa,
                              need_normal=need_normal, dtype=cdt)
        state = type(state)(*(torch.index_put(f, (idx,), nf)
                              for f, nf in zip(state, new)))
        kexit[idx] += 1
    out = finalize(state, torch.zeros(3, dtype=dt, device=dev), use_sa=use_sa)
    return out, stash, kexit


def _launch(pair_attrs, tile_start, tile_stop, grid, use_sa, need_normal,
            tile_ids, want_stash, compute_dtype):
    bf16 = dtype_of(compute_dtype) == torch.bfloat16
    r = _check_inputs(pair_attrs, grid)
    dev = pair_attrs.device
    ids = _default_ids(grid, tile_ids, dev).contiguous()
    n_sub = ids.shape[0]
    P = grid.pixels_per_tile
    attrs = _aligned(pair_attrs.detach().contiguous())
    ts = tile_start.to(torch.int32).contiguous()
    te = tile_stop.to(torch.int32).contiguous()
    for t, what in ((attrs, torch.float32), (ids, torch.int32),
                    (ts, torch.int32), (te, torch.int32)):
        _cuda.require(t, what, "raster_forward")
    out = torch.empty((n_sub, OUT_C, P), dtype=torch.float32, device=dev)
    stash = kexit = soff = None
    n_rows = stash_rows(r, n_sub)
    if want_stash:
        soff = stash_offsets(ts, te).contiguous()
        stash = torch.zeros((n_rows, STASH_C, P), dtype=torch.float32,
                            device=dev)
        kexit = torch.empty((n_sub,), dtype=torch.int32, device=dev)
    fn = _cuda.library("raster_forward").raster_forward
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    name = ("raster_forward_stash" if want_stash else "raster_forward") + (
        "_bf16" if bf16 else "")
    _cuda.LAUNCHES[name] += 1
    _cuda.check(fn(_cuda.ptr(attrs), r, _cuda.ptr(ids), _cuda.ptr(ts),
                   _cuda.ptr(te), _cuda.ptr(soff), n_sub, grid.tiles_x,
                   int(use_sa), int(need_normal), int(want_stash), n_rows,
                   int(bf16),
                   _cuda.ptr(out), _cuda.ptr(stash), _cuda.ptr(kexit),
                   _cuda.stream()), name)
    return out, stash, kexit


def raster_forward_stash(pair_attrs, tile_start, tile_stop, *, grid: TileGrid,
                         use_sa=True, need_normal=True, tile_ids=None,
                         compute_dtype: str = "f32"):
    """K1: (out [n_sub, OUT_C, P], stash [S, STASH_C, P], kexit [n_sub])."""
    if not pair_attrs.is_cuda:
        return raster_forward_plain(pair_attrs, tile_start, tile_stop,
                                    grid=grid, use_sa=use_sa,
                                    need_normal=need_normal, tile_ids=tile_ids,
                                    compute_dtype=compute_dtype)
    return _launch(pair_attrs, tile_start, tile_stop, grid, use_sa,
                   need_normal, tile_ids, True, compute_dtype)


def raster_forward(pair_attrs, tile_start, tile_stop, *, grid: TileGrid,
                   use_sa=True, need_normal=True, tile_ids=None,
                   compute_dtype: str = "f32"):
    """K3: tile-major render buffer [n_sub, OUT_C, P], no stash."""
    if not pair_attrs.is_cuda:
        return raster_forward_plain(pair_attrs, tile_start, tile_stop,
                                    grid=grid, use_sa=use_sa,
                                    need_normal=need_normal,
                                    tile_ids=tile_ids,
                                    compute_dtype=compute_dtype)[0]
    return _launch(pair_attrs, tile_start, tile_stop, grid, use_sa,
                   need_normal, tile_ids, False, compute_dtype)[0]
