"""Reference tile compositor and tile <-> image layout helpers (port of
gaus_slam_tpu/ops/composite_ref.py).

``render_tiles`` is the forward of the reference render backend: every
tile composites its pair range in TILE-LOCAL windows of ``chunk`` pairs
from its own start (the stash kernels walk 128-aligned global blocks
instead; under SA the two differ in which pairs share a block's median
target).
"""
from __future__ import annotations

import torch

from .binning import TileGrid
from .compositing import composite_chunk, finalize, init_state


def tile_pixel_coords(grid: TileGrid, t, device=None):
    """Pixel coordinates (row-major pixels) of tile t: [1, P] for one tile
    id, [n, 1, P] for a tensor of n tile ids."""
    ids = torch.as_tensor(t, device=device).long()[..., None]
    p = torch.arange(grid.pixels_per_tile, device=ids.device)
    x = (ids % grid.tiles_x) * grid.block_w + p % grid.block_w
    y = (ids // grid.tiles_x) * grid.block_h + p // grid.block_w
    return x.float().unsqueeze(-2), y.float().unsqueeze(-2)


def tiles_to_image(tiled: torch.Tensor, grid: TileGrid, height: int,
                   width: int) -> torch.Tensor:
    """[num_tiles, C, P] -> [C, H, W] (crops tile padding)."""
    t, c, p = tiled.shape
    assert t == grid.num_tiles and p == grid.pixels_per_tile
    img = tiled.reshape(grid.tiles_y, grid.tiles_x, c, grid.block_h,
                        grid.block_w)
    img = img.permute(2, 0, 3, 1, 4).reshape(
        c, grid.tiles_y * grid.block_h, grid.tiles_x * grid.block_w)
    return img[:, :height, :width]


def image_to_tiles(img: torch.Tensor, grid: TileGrid) -> torch.Tensor:
    """[C, H, W] -> tile-major [num_tiles, C, P], zero-padding edges."""
    c, h, w = img.shape
    ph = grid.tiles_y * grid.block_h - h
    pw = grid.tiles_x * grid.block_w - w
    img = torch.nn.functional.pad(img, (0, pw, 0, ph))
    img = img.reshape(c, grid.tiles_y, grid.block_h, grid.tiles_x,
                      grid.block_w)
    return img.permute(1, 3, 0, 2, 4).reshape(
        grid.num_tiles, c, grid.pixels_per_tile)


def frame_to_tiles(color: torch.Tensor, depth: torch.Tensor,
                   grid: TileGrid) -> torch.Tensor:
    """[H, W, 3] color + [H, W] depth -> tile-major [T, 4, P]."""
    img = torch.cat([color.permute(2, 0, 1), depth[None]], dim=0)
    return image_to_tiles(img, grid)


def composite_windows(rows: torch.Tensor, pair_ok, tile_start: torch.Tensor,
                      tile_stop: torch.Tensor, grid: TileGrid, *,
                      use_sa: bool = True, bg: torch.Tensor | None = None,
                      chunk: int = 128, max_pairs_per_tile: int | None = None,
                      need_normal: bool = True) -> torch.Tensor:
    """Composite the pair rows [R, ATTR_C] (``pair_ok`` [R] bool or None)
    of every tile of the grid -> [num_tiles, OUT_C, P].

    JAX's window is ``max_pairs_per_tile`` pairs from each tile's start
    (default R, so its reference backend traces num_tiles x R/chunk
    chunks); pairs at or past a tile's stop are invalid, so here the walk
    ends at the longest tile instead, with the same result. A tile leaves
    the walk once its range is exhausted or every pixel has terminated:
    an all-invalid chunk leaves the pixel state unchanged."""
    r = rows.shape[0]
    dev, dt = rows.device, rows.dtype
    n = grid.num_tiles
    P = grid.pixels_per_tile
    if bg is None:
        bg = torch.zeros(3, dtype=dt, device=dev)
    k_max = max_pairs_per_tile or r
    k_max = -(-k_max // chunk) * chunk
    start = tile_start.long()
    stop = tile_stop.long()
    lens = torch.clamp(stop - start, min=0)
    longest = int(lens.max()) if n else 0
    reach = min(k_max, -(-longest // chunk) * chunk)
    px, py = tile_pixel_coords(grid, torch.arange(n, device=dev))
    px, py = px.to(dt), py.to(dt)
    state = init_state(P, (n,), dev, dt)
    ar = torch.arange(chunk, device=dev)
    for c0 in range(0, reach, chunk):
        live = (lens > c0) & (state.done.amin(dim=(-2, -1)) < 0.5)
        idx = torch.nonzero(live)[:, 0]
        if idx.numel() == 0:
            break
        gi = start[idx, None] + c0 + ar
        safe = torch.clamp(gi, 0, r - 1)
        valid = gi < stop[idx, None]
        if pair_ok is not None:
            valid = valid & pair_ok[safe]
        sub = type(state)(*(f[idx] for f in state))
        idx_base = torch.full((idx.numel(), 1, 1), c0 + 1, device=dev)
        new = composite_chunk(sub, rows[safe], px[idx], py[idx], idx_base,
                              valid[..., None].to(dt), use_sa=use_sa,
                              need_normal=need_normal)
        state = type(state)(*(torch.index_put(f, (idx,), nf)
                              for f, nf in zip(state, new)))
    return finalize(state, bg, use_sa=use_sa)


def render_tiles(attrs_t: torch.Tensor, binning, grid: TileGrid, *,
                 use_sa: bool = True, bg: torch.Tensor | None = None,
                 chunk: int = 128, max_pairs_per_tile: int | None = None,
                 need_normal: bool = True) -> torch.Tensor:
    """Render all tiles of a binning -> [num_tiles, OUT_C, P] from the
    per-gaussian packed attributes [N, ATTR_C]."""
    rows = attrs_t[binning.pair_gauss.long()]
    return composite_windows(rows, binning.pair_ok, binning.tile_start,
                             binning.tile_stop, grid, use_sa=use_sa, bg=bg,
                             chunk=chunk,
                             max_pairs_per_tile=max_pairs_per_tile,
                             need_normal=need_normal)
