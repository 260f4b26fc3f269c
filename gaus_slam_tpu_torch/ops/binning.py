"""Tile binning: expand gaussians into depth-sorted per-tile pair lists
(port of gaus_slam_tpu/ops/binning.py).

Every gaussian emits exactly D_MAX candidate pairs on a [D_MAX, N] slab;
unused slots get a sentinel key and sort to the tail. One stable sort of
the int32 key ``tile << depth_bits | (float bits >> (32 - depth_bits))``
produces the depth-ordered per-tile lists under a static pair budget
``r_max`` (overflow is reported, not resized).

The gradient reduction (``Binning.slab_scatter_grads`` /
``phase_reduce``) lands its per-gaussian run totals through the
``monotone_row_gather_rows`` kernel (K4, ops/gather.py) on the card under the
"pallas" / "interpret" render backends, and through the plain gather
otherwise (the JAX package's routing).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .camera import Camera
from .gather import monotone_row_gather_rows, monotone_row_gather_rows_plain

SENTINEL = 0x7FFFFFFF


class TileGrid(NamedTuple):
    tiles_x: int
    tiles_y: int
    block_w: int
    block_h: int

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def pixels_per_tile(self) -> int:
        return self.block_w * self.block_h


def make_grid(cam: Camera, block_h: int = 16, block_w: int = 16) -> TileGrid:
    return TileGrid(
        tiles_x=-(-cam.width // block_w),
        tiles_y=-(-cam.height // block_h),
        block_w=block_w,
        block_h=block_h,
    )


def _empty_i32(device):
    return torch.zeros((0,), dtype=torch.int32, device=device)


def _shift_rows(x: torch.Tensor, s: int, fill) -> torch.Tensor:
    """x shifted down by s rows along dim 0 (the first s rows = fill)."""
    head = torch.full((s,) + x.shape[1:], fill, dtype=x.dtype, device=x.device)
    return torch.cat([head, x[:-s]], dim=0)


def _segmented_scan(acc: torch.Tensor, keys: torch.Tensor,
                    d_max: int) -> torch.Tensor:
    """Segmented inclusive scan (Hillis-Steele doubling) over rows sorted
    by key: each run's LAST row ends with the run total; runs are at most
    d_max long."""
    s = 1
    while s < d_max:
        shifted = _shift_rows(acc, s, 0.0)
        kshift = _shift_rows(keys, s, -1)
        acc = acc + torch.where((kshift == keys)[:, None], shifted,
                                torch.zeros_like(shifted))
        s *= 2
    return acc


def _land(acc: torch.Tensor, pos: torch.Tensor,
          backend: str | None) -> torch.Tensor:
    """Run totals at positions ``pos`` (monotone): [R, C] -> [N, C],
    through the K4 row gather for the "pallas" / "interpret" backends,
    the plain gather otherwise."""
    if backend in ("pallas", "interpret"):
        return monotone_row_gather_rows(acc, pos)
    return monotone_row_gather_rows_plain(acc, pos)


class Binning(NamedTuple):
    pair_gauss: torch.Tensor  # [r_max] int32 gaussian index per sorted pair
    pair_slab: torch.Tensor   # [r_max] int32 flat slab slot (d * N + g)
    slab_tail: torch.Tensor   # [d_max*N - r_max] slots sliced off by the budget
    pair_ok: torch.Tensor     # [r_max] bool: pair is real (not padding)
    tile_start: torch.Tensor  # [num_tiles] int32 into the sorted pair array
    tile_stop: torch.Tensor   # [num_tiles] int32
    num_tiles_touched: int    # static: d_max used for the slab expansion
    num_pairs: torch.Tensor   # scalar int32 (clipped to r_max)
    overflow: torch.Tensor    # scalar bool: pair budget exceeded
    demand: torch.Tensor      # scalar int32: true (unclipped) pair demand
    n_shrunk: torch.Tensor    # scalar int32: rects shrunk to fit d_max
    counts: torch.Tensor      # [N] int32 pairs emitted per gaussian
    red_keys: torch.Tensor | None = None    # [R] sorted reduction keys
    red_perm: torch.Tensor | None = None    # [R] their sort permutation
    phase_start: torch.Tensor | None = None  # [s^2+1] phase-block bounds
    slab_phase: torch.Tensor | None = None   # [d_max, N] phase per slot

    def slab_scatter_grads(self, pair_grads: torch.Tensor, n: int,
                           d_max: int | None = None,
                           backend: str | None = None) -> torch.Tensor:
        """Reduce per-pair gradients [R, C] -> per-gaussian [N, C].

        Run path (no budget truncation): sort by gaussian, segmented
        scan, land run totals with one K4 gather. Slab path (overflow):
        sort rows by slab slot and tree-sum over d. JAX's ``lax.cond``
        on the device overflow flag becomes a host read here."""
        d_max = d_max if d_max is not None else self.num_tiles_touched
        if bool(self.overflow):
            return self._slab_reduce(pair_grads, n, d_max)
        return self._run_reduce(pair_grads, n, d_max, backend)

    def phase_reduce(self, d_pairs_sub: torch.Tensor, phase: int, n: int,
                     d_max: int, backend: str | None = None) -> torch.Tensor:
        """Per-gaussian reduce of ONE coarse phase's compact pair grads
        [r_phase, C], indexed from the 128-aligned floor of the phase
        start (phase-major binning with ``reduce_perm``)."""
        r_phase, c = d_pairs_sub.shape
        dev = d_pairs_sub.device
        p0 = self.phase_start[phase].long()
        p1 = self.phase_start[phase + 1].long()
        p0_al = (p0 // 128) * 128
        keys_pad = torch.cat([self.red_keys, torch.full(
            (r_phase,), SENTINEL, dtype=torch.int32, device=dev)])
        perm_pad = torch.cat([self.red_perm, torch.zeros(
            (r_phase,), dtype=torch.int32, device=dev)])
        ar = torch.arange(r_phase, device=dev)
        keys_blk = keys_pad[p0 + ar]
        perm_blk = perm_pad[p0 + ar].long()
        valid = ar < (p1 - p0)
        loc = torch.clamp(perm_blk - p0_al, 0, r_phase - 1)
        grads_sorted = torch.where(valid[:, None], d_pairs_sub[loc],
                                   torch.zeros((), device=dev))
        keys_blk = torch.where(valid, keys_blk,
                               torch.full_like(keys_blk, SENTINEL))
        acc = _segmented_scan(grads_sorted, keys_blk, d_max)
        counts_p = torch.sum(self.slab_phase == phase, dim=0)
        pos = torch.clamp(torch.cumsum(counts_p, 0) - 1, 0,
                          r_phase - 1).to(torch.int32)
        out = _land(acc, pos, backend)
        exact = torch.logical_not(self.overflow) & ((p1 - p0_al) <= r_phase)
        keep = (counts_p > 0)[:, None] & exact
        return torch.where(keep, out, torch.zeros((), device=dev))

    def _slab_reduce(self, pair_grads: torch.Tensor, n: int,
                     d_max: int) -> torch.Tensor:
        r, c = pair_grads.shape
        total = d_max * n
        keys = torch.cat([self.pair_slab, self.slab_tail])
        pad = keys.shape[0] - r
        perm = torch.sort(keys, stable=True).indices
        grads_p = torch.where(self.pair_ok[:, None], pair_grads,
                              torch.zeros((), device=pair_grads.device))
        grads_p = torch.nn.functional.pad(grads_p, (0, 0, 0, pad))
        slab = grads_p[perm[:total]]
        return slab.reshape(d_max, n, c).sum(dim=0)

    def _run_reduce(self, pair_grads: torch.Tensor, n: int,
                    d_max: int, backend: str | None) -> torch.Tensor:
        r, _ = pair_grads.shape
        dev = pair_grads.device
        if self.red_perm is not None and self.red_perm.shape[0]:
            keys_sorted, perm = self.red_keys, self.red_perm.long()
        else:
            keys = torch.where(self.pair_ok, self.pair_gauss,
                               torch.full_like(self.pair_gauss, n))
            keys_sorted, perm = torch.sort(keys, stable=True)
        grads_sorted = torch.where(self.pair_ok[:, None], pair_grads,
                                   torch.zeros((), device=dev))[perm]
        acc = _segmented_scan(grads_sorted, keys_sorted, d_max)
        pos = torch.clamp(torch.cumsum(self.counts, 0) - 1, 0,
                          r - 1).to(torch.int32)
        out = _land(acc, pos, backend)
        return torch.where((self.counts > 0)[:, None], out,
                           torch.zeros((), device=dev))


def gaussian_rects(pre, grid: TileGrid):
    """Per-gaussian tile rectangle, replicating CUDA getRect int
    truncation and the clamp to the grid."""
    bw, bh = float(grid.block_w), float(grid.block_h)
    cx, cy = pre.center[:, 0], pre.center[:, 1]
    r = pre.radius

    def cell(v, hi):
        return torch.clamp(torch.trunc(v), 0, hi).to(torch.int32)

    x0 = cell((cx - r) / bw, grid.tiles_x)
    y0 = cell((cy - r) / bh, grid.tiles_y)
    x1 = cell((cx + r + bw - 1) / bw, grid.tiles_x)
    y1 = cell((cy + r + bh - 1) / bh, grid.tiles_y)
    w = torch.clamp(x1 - x0, min=0)
    h = torch.clamp(y1 - y0, min=0)
    counts = torch.where(pre.valid, w * h, torch.zeros_like(w))
    return x0, y0, w, counts


def phase_positions(stride: int, nested: bool) -> np.ndarray:
    """Position of checkerboard phase (oy*s + ox) in the phase-major
    order; ``nested`` makes every power-of-2-coarser checkerboard a
    prefix (strides 2 and 4)."""
    s = stride
    if not nested:
        return np.arange(s * s)
    assert s % 2 == 0 and s <= 4, "nested phase order needs stride 2 or 4"
    h = s // 2
    oy, ox = np.divmod(np.arange(s * s), s)
    return (((oy % 2) * 2 + (ox % 2)) * h * h
            + (oy // 2) * h + (ox // 2))


def phase_tables(grid: TileGrid, stride: int, nested: bool = False):
    """Static phase-major tile tables: (rank_of_tile [T] int32,
    base [s^2+1] int64 cumulative tile counts per position,
    pos_of_phase [s^2])."""
    s = stride
    ty, tx = np.divmod(np.arange(grid.tiles_y * grid.tiles_x), grid.tiles_x)
    oy, ox = ty % s, tx % s
    phase = oy * s + ox
    ny = -(-(grid.tiles_y - np.arange(s)) // s)
    nx = -(-(grid.tiles_x - np.arange(s)) // s)
    sizes = (ny[:, None] * nx[None, :]).reshape(-1)
    pos = phase_positions(s, nested)
    sizes_by_pos = np.zeros_like(sizes)
    sizes_by_pos[pos] = sizes
    base = np.concatenate([[0], np.cumsum(sizes_by_pos)])
    rank = base[pos[phase]] + (ty // s) * nx[ox] + tx // s
    return rank.astype(np.int32), base.astype(np.int64), pos


def _phase_rank_expr(tile, grid: TileGrid, stride: int, base: np.ndarray,
                     pos: np.ndarray):
    """Elementwise tile-id -> (phase-major rank, phase position)."""
    s = stride
    ty = tile // grid.tiles_x
    tx = tile - ty * grid.tiles_x
    oy, ox = ty % s, tx % s
    phase = oy * s + ox
    nx = [-(-(grid.tiles_x - o) // s) for o in range(s)]
    nx_ox = torch.zeros_like(tile)
    b = torch.zeros_like(tile)
    pv = torch.zeros_like(tile)
    for o in range(s):
        nx_ox = torch.where(ox == o, torch.full_like(tile, nx[o]), nx_ox)
    for p in range(s * s):
        b = torch.where(phase == p, torch.full_like(tile, int(base[pos[p]])), b)
        pv = torch.where(phase == p, torch.full_like(tile, int(pos[p])), pv)
    rank = b + (ty // s) * nx_ox + tx // s
    return rank, pv


def _shr_logical(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 (torch's >> is arithmetic)."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def bin_gaussians(pre, grid: TileGrid, r_max: int | None = None,
                  max_tiles_per_gaussian: int = 16, reduce_perm: bool = False,
                  phase_stride: int = 0,
                  phase_nested: bool = False) -> Binning:
    """Gather-free slab expansion + one stable sort (see module doc).

    A gaussian covering more than ``max_tiles_per_gaussian`` tiles has
    its radius shrunk symmetrically until its rect fits (``n_shrunk``)."""
    n = pre.depth.shape[0]
    dev = pre.depth.device
    i32 = torch.int32
    num_tiles = grid.num_tiles
    d_max = max_tiles_per_gaussian
    if r_max is None:
        r_max = -(-(d_max * n) // 128) * 128
    tile_bits = max(int(num_tiles).bit_length(), 1)
    depth_bits = 31 - tile_bits
    assert depth_bits >= 12, f"tile grid too large: {num_tiles} tiles"

    x0, y0, w, counts = gaussian_rects(pre, grid)
    n_shrunk = torch.sum(counts > d_max).to(i32)
    shrink = torch.sqrt(d_max / torch.clamp(counts, min=1).float())
    radius_fit = torch.where(counts > d_max, pre.radius * shrink * 0.999,
                             pre.radius)
    x0, y0, w, counts = gaussian_rects(pre._replace(radius=radius_fit), grid)
    counts = torch.clamp(counts, max=d_max)

    d = torch.arange(d_max, dtype=i32, device=dev)[:, None]
    w_safe = torch.clamp(w, min=1)[None, :]
    tx = x0[None, :] + d % w_safe
    ty = y0[None, :] + d // w_safe
    tile = ty * grid.tiles_x + tx
    live = d < counts[None, :]

    if phase_stride > 0:
        n_phase = phase_stride * phase_stride
        rank_np, base_np, pos_np = phase_tables(grid, phase_stride,
                                                nested=phase_nested)
        sort_tile, slab_ph = _phase_rank_expr(tile, grid, phase_stride,
                                              base_np, pos_np)
        slab_phase = torch.where(live, slab_ph,
                                 torch.full_like(slab_ph, n_phase)).to(i32)
    else:
        sort_tile = tile
        slab_phase = None

    dq = torch.clamp(pre.depth, min=1e-12).float().contiguous().view(i32)
    dq = _shr_logical(dq, 32 - depth_bits)

    key = (sort_tile << depth_bits) | dq[None, :]
    key = torch.where(live, key, torch.full_like(key, SENTINEL)).reshape(-1)

    key_sorted, order = torch.sort(key, stable=True)
    pair_slab = order.to(i32)  # sorting (key, slab slot) by key
    if key_sorted.shape[0] >= r_max:
        slab_tail = pair_slab[r_max:]
        key_sorted, pair_slab = key_sorted[:r_max], pair_slab[:r_max]
    else:
        pad = r_max - key_sorted.shape[0]
        key_sorted = torch.cat([key_sorted, torch.full(
            (pad,), SENTINEL, dtype=i32, device=dev)])
        pair_slab = torch.cat([
            pair_slab,
            d_max * n + torch.arange(pad, dtype=i32, device=dev),
        ])
        slab_tail = _empty_i32(dev)
    pair_gauss = pair_slab % n
    pair_ok = key_sorted != SENTINEL
    total = torch.sum(counts)

    overflow = total > r_max
    tile_keys = torch.arange(num_tiles + 1, dtype=i32, device=dev) << depth_bits
    bounds = torch.searchsorted(key_sorted, tile_keys, right=False).to(i32)
    if phase_stride > 0:
        rank_t = torch.as_tensor(rank_np, dtype=torch.long, device=dev)
        tile_start = bounds[rank_t]
        tile_stop = bounds[rank_t + 1]
        phase_start = bounds[torch.as_tensor(base_np, device=dev)]
    else:
        tile_start = bounds[:-1]
        tile_stop = bounds[1:]
        phase_start = None
    red_keys = red_perm = None
    if reduce_perm:
        if phase_stride > 0:
            rank_sorted = _shr_logical(key_sorted, depth_bits)
            pair_phase = torch.zeros_like(rank_sorted)
            for p in range(1, n_phase):
                pair_phase = pair_phase + (
                    rank_sorted >= int(base_np[p])).to(i32)
            rkeys = torch.where(pair_ok, pair_phase * (n + 1) + pair_gauss,
                                torch.full_like(pair_gauss, n_phase * (n + 1)))
        else:
            rkeys = torch.where(pair_ok, pair_gauss,
                                torch.full_like(pair_gauss, n))
        red_keys, perm = torch.sort(rkeys, stable=True)
        red_perm = perm.to(i32)
    return Binning(
        pair_gauss=pair_gauss,
        pair_slab=pair_slab,
        slab_tail=slab_tail,
        pair_ok=pair_ok,
        tile_start=tile_start,
        tile_stop=tile_stop,
        num_tiles_touched=d_max,
        num_pairs=torch.clamp(total, max=r_max).to(i32),
        demand=total.to(i32),
        overflow=overflow,
        n_shrunk=n_shrunk,
        counts=counts.to(i32),
        red_keys=red_keys,
        red_perm=red_perm,
        phase_start=phase_start,
        slab_phase=slab_phase,
    )
