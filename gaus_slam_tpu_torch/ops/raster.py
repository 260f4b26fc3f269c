"""Differentiable 2DGS rasterization — public op (port of
gaus_slam_tpu/ops/raster.py).

``render_pairs``: pair-expanded attributes [ATTR_C, R] in, tile-major
render buffer [n_sub, OUT_C, P] out, as a ``torch.autograd.Function``.

``RenderSettings.backend`` takes the JAX package's names:
  * "pallas" / "interpret" (the stash path): on a CUDA tensor the forward
    is K1 (with stash) and the backward K2; a call that needs no gradient
    launches K3 instead. On the CPU both directions run the plain
    versions, including ``tile_ids`` subsets.
  * "reference": the forward is the plain ``composite_ref`` compositor
    (tile-local windows, no stash) on every device, and the backward is
    K5 on a CUDA tensor (its plain version on the CPU). All tiles only:
    tile subsets are refused, as the JAX package asserts.

``RenderSettings.compute_dtype`` ("f32" or "bf16") is the dtype of the
stash path's per-pair chain; the reference backend ignores it, as in the
JAX package (its compositor and K5 take none).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .binning import TileGrid
from .composite_ref import composite_windows
from .raster_backward import raster_backward, raster_backward_stash
from .raster_forward import raster_forward, raster_forward_stash

BACKENDS = ("pallas", "interpret", "reference")


class RenderSettings(NamedTuple):
    grid: TileGrid
    use_sa: bool = True
    backend: str = "pallas"  # pallas | interpret | reference
    need_normal: bool = True  # gate normal accumulation + its grad paths
    compute_dtype: str = "f32"  # f32 | bf16: the stash path's pair chain


class _RenderPairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pair_attrs, tile_start, tile_stop, tile_ids, settings,
                grad_mode):
        kw = dict(grid=settings.grid, use_sa=settings.use_sa,
                  need_normal=settings.need_normal, tile_ids=tile_ids,
                  compute_dtype=settings.compute_dtype)
        ctx.settings = settings
        if not (grad_mode and ctx.needs_input_grad[0]):
            # no gradient wanted: the forward without stash (K3)
            return raster_forward(pair_attrs, tile_start, tile_stop, **kw)
        out, stash, kexit = raster_forward_stash(pair_attrs, tile_start,
                                                 tile_stop, **kw)
        ctx.save_for_backward(pair_attrs, tile_start, tile_stop, tile_ids,
                              out, stash, kexit)
        return out

    @staticmethod
    def backward(ctx, d_out):
        pair_attrs, tile_start, tile_stop, tile_ids, out, stash, kexit = \
            ctx.saved_tensors
        s = ctx.settings
        d_attrs = raster_backward_stash(
            pair_attrs, tile_start, tile_stop, stash, kexit, out,
            d_out.contiguous(), grid=s.grid, use_sa=s.use_sa,
            need_normal=s.need_normal, tile_ids=tile_ids,
            compute_dtype=s.compute_dtype)
        return d_attrs, None, None, None, None, None


class _RenderPairsReference(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pair_attrs, tile_start, tile_stop, settings):
        ctx.settings = settings
        out = composite_windows(
            pair_attrs.detach().T, None, tile_start, tile_stop,
            settings.grid, use_sa=settings.use_sa,
            max_pairs_per_tile=pair_attrs.shape[1],
            need_normal=settings.need_normal)
        ctx.save_for_backward(pair_attrs, tile_start, tile_stop, out)
        return out

    @staticmethod
    def backward(ctx, d_out):
        pair_attrs, tile_start, tile_stop, out = ctx.saved_tensors
        s = ctx.settings
        d_attrs = raster_backward(pair_attrs, tile_start, tile_stop, out,
                                  d_out.contiguous(), grid=s.grid,
                                  use_sa=s.use_sa, need_normal=s.need_normal)
        return d_attrs, None, None, None


def render_pairs(pair_attrs, tile_start, tile_stop, tile_ids,
                 settings: RenderSettings):
    """[ATTR_C, R] pair attrs -> [n_sub, OUT_C, P] render buffer.
    ``tile_ids`` (None = all tiles) selects the image tiles to render;
    ``tile_start``/``tile_stop`` are the matching subset rows."""
    if settings.backend not in BACKENDS:
        raise ValueError(f"unknown render backend {settings.backend!r}")
    if settings.backend == "reference":
        if tile_ids is not None:
            raise ValueError("the reference render backend renders all "
                             "tiles; tile subsets need the stash kernels")
        return _RenderPairsReference.apply(pair_attrs, tile_start, tile_stop,
                                           settings)
    if tile_ids is None:
        tile_ids = torch.arange(settings.grid.num_tiles, dtype=torch.int32,
                                device=pair_attrs.device)
    return _RenderPairs.apply(pair_attrs, tile_start, tile_stop, tile_ids,
                              settings, torch.is_grad_enabled())
