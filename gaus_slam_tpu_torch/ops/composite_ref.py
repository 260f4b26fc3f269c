"""Tile <-> image layout helpers (port of the layout part of
gaus_slam_tpu/ops/composite_ref.py)."""
from __future__ import annotations

import torch

from .binning import TileGrid


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
