"""Render facade — tracking / mapping / view modes over the
static-capacity Gaussian map (port of gaus_slam_tpu/render/__init__.py).

Two render methods share the binning and the compositing kernels:
"2dgs" (surfels, the lane-major ``preprocess_t``) and "3dgs" (volumetric
gaussians, the EWA conic of ``ops/preprocess_3dgs.py`` packed through
``pack_pair_attrs``; surface-aware depth fusion off, middepth and
distortion zeroed, as the reference's render_3dgs.py returns them).

Gradient boundaries as in the reference:
  * tracking: map parameters detached, gaussians rigidly moved into the
    camera frame by the LIVE pose (gradient flows through the means
    only; the rotated quaternions are detached), camera matrix = identity.
  * mapping:  pose fixed (detached) inside the camera matrix, map
    parameters live.
  * view:     everything detached (keyframe test / densification).

The pair expansion of the mapping path is an ``autograd.Function`` whose
backward is the per-gaussian gradient reduction, landing through the K4
gather (``Binning.slab_scatter_grads`` / ``phase_reduce``) under the
"pallas" / "interpret" backends and through the plain gather under
"reference", as the JAX package routes it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.gaussians import GaussianMap, Params
from ..ops import binning as B
from ..ops.camera import Camera
from ..ops.compositing import OUT_C
from ..ops.preprocess import PreSummary, pack_pair_attrs, preprocess_t
from ..ops.raster import RenderSettings, render_pairs
from ..ops.se3 import (pose_matrix, quat_multiply, quat_multiply_rows,
                       quat_normalize, rotmat_to_quat)


class RenderOptions(NamedTuple):
    """Static render configuration: the tile grid, the render method
    ("2dgs" surfels or "3dgs" volumetric gaussians, ``iso3d`` for the
    isotropic ones), surface-aware depth fusion, the compositing backend
    and the pair budget."""

    grid: B.TileGrid
    use_sa: bool = True
    backend: str = "pallas"    # pallas | interpret | reference (ops/raster)
    # r_max = factor * capacity, or pair_cap rows when > 0
    pair_budget_factor: float = 2
    pair_cap: int = 0
    max_tiles_per_gaussian: int = 16
    normals_in_tracking: bool = False  # loss.use_normal_loss
    method: str = "2dgs"          # "2dgs" surfels | "3dgs" volumetric
    iso3d: bool = False           # gaussian_distribution == isotropic
    compute_dtype: str = "f32"    # tpu.compute_dtype: f32 | bf16

    def settings(self, need_normal: bool = True) -> RenderSettings:
        # surface-aware depth fusion is a feature of the 2DGS rasterizer;
        # the 3DGS method composites plain weighted depth
        return RenderSettings(grid=self.grid,
                              use_sa=self.use_sa and self.method == "2dgs",
                              backend=self.backend, need_normal=need_normal,
                              compute_dtype=self.compute_dtype)

    def r_max(self, n: int) -> int:
        if self.pair_cap > 0:
            return -(-int(self.pair_cap) // 128) * 128
        return -(-int(self.pair_budget_factor * n) // 128) * 128


# ---------------------------------------------------------------------------
# pair expansion with a controlled backward (the mapping-path reduction)


class _ExpandPairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attrs_t, bins, d_max, backend):
        ctx.bins, ctx.n, ctx.d_max = bins, attrs_t.shape[0], d_max
        ctx.backend = backend
        return attrs_t[bins.pair_gauss.long()].T.contiguous()

    @staticmethod
    def backward(ctx, d_pairs):
        g = ctx.bins.slab_scatter_grads(d_pairs.T, ctx.n, d_max=ctx.d_max,
                                        backend=ctx.backend)
        return g, None, None, None


def expand_pairs(attrs_t: torch.Tensor, bins: B.Binning, d_max: int,
                 backend: str | None = None):
    """[N, ATTR_C] per-gaussian attrs -> [ATTR_C, R] pair-expanded.
    ``backend`` routes the gradient reduction's landing gather."""
    return _ExpandPairs.apply(attrs_t, bins, d_max, backend)


def _phase_base(bins: B.Binning, phase) -> torch.Tensor:
    """128-aligned floor of the phase's first pair index (device);
    ``phase`` a python int or a device int scalar."""
    return (B.row(bins.phase_start, phase).long() // 128) * 128


def _phase_rows(attrs_t, bins, phase, r_phase):
    # slice from the 128-ALIGNED floor of the phase start, so every pair
    # keeps its offset mod 128 (the kernels' block grouping)
    dev = attrs_t.device
    gauss_pad = torch.cat([bins.pair_gauss,
                           torch.zeros((r_phase,), dtype=torch.int32, device=dev)])
    idx = _phase_base(bins, phase) + torch.arange(r_phase, device=dev)
    return attrs_t[gauss_pad[idx].long()].T.contiguous()


class _ExpandPairsPhase(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attrs_t, bins, phase, r_phase, d_max, backend):
        ctx.bins, ctx.phase, ctx.n, ctx.d_max = bins, phase, attrs_t.shape[0], d_max
        ctx.backend = backend
        return _phase_rows(attrs_t, bins, phase, r_phase)

    @staticmethod
    def backward(ctx, d_pairs):
        g = ctx.bins.phase_reduce(d_pairs.T, ctx.phase, ctx.n, ctx.d_max,
                                  backend=ctx.backend)
        return g, None, None, None, None, None


def expand_pairs_phase(attrs_t, bins: B.Binning, phase: int, r_phase: int,
                       d_max: int, backend: str | None = None):
    """[N, ATTR_C] attrs -> [ATTR_C, r_phase] pair block of ONE coarse
    phase of a phase-major binning (a contiguous slice of the pairs)."""
    return _ExpandPairsPhase.apply(attrs_t, bins, phase, r_phase, d_max,
                                   backend)


def phase_budget(opts: RenderOptions, n: int, stride: int) -> int:
    """Static per-phase pair budget: 2x the average phase share of r_max
    plus one 128-lane head."""
    return -(-(2 * opts.r_max(n)) // (stride * stride * 128)) * 128 + 128


def track_coarse_budget(r_max: int, stride: int) -> int:
    """Static pair budget for the tracking cache's coarse head block."""
    return min(r_max, -(-(2 * r_max) // (stride * stride * 128)) * 128)


# ---------------------------------------------------------------------------


def _preprocess_3dgs(xyz, scales, quats, opac, cam: Camera,
                     opts: RenderOptions, active=None):
    """The 3DGS method's preprocess on activated [N, C] fields."""
    from ..ops.preprocess_3dgs import preprocess_3dgs, scales_to_3d

    return preprocess_3dgs(xyz, scales_to_3d(scales, opts.iso3d), quats,
                           opac, cam, active=active)


def _prep_attrs(params: Params, active, cam: Camera, opts: RenderOptions):
    """Activations + preprocess -> ([PAIR_C, N] attrs, PreSummary): the
    lane-major ``preprocess_t`` for 2DGS, the [N, C] EWA preprocess and
    ``pack_pair_attrs`` for 3DGS."""
    if opts.method == "3dgs":
        pre = _preprocess_3dgs(
            params.xyz, torch.exp(params.log_scales), params.quats,
            torch.sigmoid(params.opacity_logit[:, 0]), cam, opts,
            active=active)
        summary = PreSummary(valid=pre.valid, center=pre.center,
                             radius=pre.radius, depth=pre.depth)
        return pack_pair_attrs(pre, params.rgb), summary
    return preprocess_t(
        params.xyz.T,
        torch.exp(params.log_scales.T),
        params.quats.T,
        torch.sigmoid(params.opacity_logit[:, 0]),
        params.rgb.T,
        cam,
        active=active,
    )


def _method_mask(out: torch.Tensor, opts: RenderOptions) -> torch.Tensor:
    """The 3DGS method returns zeros for middepth and distortion (rows 8
    and 9; its normals are zero by construction)."""
    if opts.method != "3dgs":
        return out
    keep = torch.ones((1, OUT_C, 1), dtype=out.dtype, device=out.device)
    keep[0, 8:10, 0] = 0.0
    return out * keep


def _detached(summary):
    return type(summary)(*(f.detach() for f in summary))


def bin_full(params: Params, active, cam: Camera, opts: RenderOptions,
             phase_stride: int = 0) -> B.Binning:
    """Binning pass alone (non-differentiable structure)."""
    with torch.no_grad():
        _, summary = _prep_attrs(params, active, cam, opts)
        return B.bin_gaussians(
            summary, opts.grid, r_max=opts.r_max(params.xyz.shape[0]),
            max_tiles_per_gaussian=opts.max_tiles_per_gaussian,
            reduce_perm=True, phase_stride=phase_stride,
        )


def render_full(params: Params, active, cam: Camera, opts: RenderOptions,
                bins: B.Binning | None = None, need_normal: bool = True,
                tile_ids=None, tile_valid=None, phase: int | None = None,
                coarse_stride: int = 0):
    """Differentiable full-map render (mapping / view paths).

    Returns (out_tiled [T or len(tile_ids), OUT_C, P], bins). ``phase`` /
    ``coarse_stride``: compact coarse path over a phase-major ``bins``
    (expansion + gradient reduction on the phase's pair block)."""
    attrs, summary = _prep_attrs(params, active, cam, opts)
    if bins is None:
        assert phase is None, "compact phase render needs phase-major bins"
        bins = B.bin_gaussians(
            _detached(summary), opts.grid,
            r_max=opts.r_max(params.xyz.shape[0]),
            max_tiles_per_gaussian=opts.max_tiles_per_gaussian,
        )
    attrs_t = attrs.T
    if phase is not None:
        assert tile_ids is not None and coarse_stride > 0
        r_phase = phase_budget(opts, params.xyz.shape[0], coarse_stride)
        pattrs = expand_pairs_phase(attrs_t, bins, phase, r_phase,
                                    opts.max_tiles_per_gaussian, opts.backend)
        p0_al = _phase_base(bins, phase)
        ids = tile_ids.long()
        start = torch.clamp(bins.tile_start[ids] - p0_al, 0, r_phase)
        stop = torch.clamp(bins.tile_stop[ids] - p0_al, 0, r_phase)
        if tile_valid is not None:
            # padded duplicate entries render EMPTY
            stop = torch.where(tile_valid, stop, start)
        out = render_pairs(pattrs, start.int(), stop.int(), tile_ids,
                           opts.settings(need_normal=need_normal))
        return _method_mask(out, opts), bins
    pattrs = expand_pairs(attrs_t, bins, opts.max_tiles_per_gaussian,
                          opts.backend)
    if tile_ids is None:
        start, stop = bins.tile_start, bins.tile_stop
    else:
        ids = tile_ids.long()
        start, stop = bins.tile_start[ids], bins.tile_stop[ids]
        if tile_valid is not None:
            stop = torch.where(tile_valid, stop, start)
    out = render_pairs(pattrs, start, stop, tile_ids,
                       opts.settings(need_normal=need_normal))
    return _method_mask(out, opts), bins


def render_view(gm: GaussianMap, cam: Camera, opts: RenderOptions):
    """Detached render at a fixed pose (Renderer_view); launches K3 (the
    plain compositor under the reference backend)."""
    with torch.no_grad():
        out, _ = render_full(gm.params, gm.active, cam, opts)
    return out


class PairCache(NamedTuple):
    """Frozen pair-expanded raw map for the tracking hot loop."""

    raw_t: torch.Tensor     # [13, R] = xyz | scales | quats | opac | rgb
    tile_start: torch.Tensor
    tile_stop: torch.Tensor
    num_pairs: torch.Tensor
    overflow: torch.Tensor
    n_shrunk: torch.Tensor
    demand: torch.Tensor

    @property
    def xyz_t(self):
        return self.raw_t[0:3]

    @property
    def scales_t(self):
        return self.raw_t[3:5]

    @property
    def quats_t(self):
        return self.raw_t[5:9]

    @property
    def opac(self):
        return self.raw_t[9]

    @property
    def rgb_t(self):
        return self.raw_t[10:13]


def bin_for_tracking(gm: GaussianMap, cam0: Camera, opts: RenderOptions,
                     coarse_stride: int = 0,
                     coarse_strides: tuple = ()) -> PairCache:
    """Binning + raw-param pair expansion at the tracking init pose.

    ``coarse_strides`` (coarse -> fine) orders the pairs PHASE-MAJOR at
    the coarsest stride (nested order for several levels), so every
    coarse level's checkerboard is a head block of the cache arrays."""
    with torch.no_grad():
        p = gm.params
        xyz = p.xyz
        scales = torch.exp(p.log_scales)
        opac = torch.sigmoid(p.opacity_logit[:, 0])
        _, summary = _prep_attrs(p, gm.active, cam0, opts)
        r_max = opts.r_max(xyz.shape[0])
        strides = tuple(s for s in (coarse_strides or
                                    ((coarse_stride,) if coarse_stride > 1
                                     else ())) if s > 1)
        sb = strides[0] if strides else 0
        if len(strides) > 1:
            assert all(strides[i] % strides[i + 1] == 0
                       for i in range(len(strides) - 1)), strides
        bins = B.bin_gaussians(
            summary, opts.grid, r_max=r_max,
            max_tiles_per_gaussian=opts.max_tiles_per_gaussian,
            phase_stride=sb, phase_nested=len(strides) > 1,
        )
        assert bins.pair_gauss.shape[0] == r_max, \
            (bins.pair_gauss.shape, r_max)
        overflow = bins.overflow
        for s_l in strides:
            n_pfx = (sb // s_l) ** 2
            r_l = track_coarse_budget(r_max, s_l)
            overflow = overflow | (bins.phase_start[n_pfx] > r_l)
        opac_act = torch.where(gm.active, opac, torch.zeros_like(opac))
        raw = torch.cat([xyz, scales, p.quats, opac_act[:, None], p.rgb], dim=1)
        rows = raw[bins.pair_gauss.long()]
        rows[:, 9] = torch.where(bins.pair_ok, rows[:, 9],
                                 torch.zeros_like(rows[:, 9]))
        return PairCache(
            raw_t=rows.T.contiguous(),
            tile_start=bins.tile_start, tile_stop=bins.tile_stop,
            num_pairs=bins.num_pairs, overflow=overflow,
            n_shrunk=bins.n_shrunk, demand=bins.demand,
        )


def render_tracking(cache: PairCache, pose_quat, pose_trans, cam_proj: Camera,
                    opts: RenderOptions, tile_ids=None,
                    pair_hi: int | None = None, pre_w2c=None):
    """Tracking-mode render: pair-cached map moved by the live pose.

    ``pair_hi`` slices the (phase-major) cache to its first ``pair_hi``
    pair rows; a tile whose range extends past the slice renders EMPTY.

    ``pre_w2c``: a fixed [4, 4] composed left of the live pose, so the
    effective camera is ``pre_w2c @ pose_matrix(quat, trans)`` (backend
    tracking: the live submap transform under a fixed frame-in-submap
    pose); the detached quaternion rotation is then q_pre * q. Under
    3DGS the moved means carry the pose gradient into the EWA
    preprocess."""
    if pair_hi is not None and pair_hi < cache.raw_t.shape[1]:
        start_c = torch.clamp(cache.tile_start, max=pair_hi)
        stop_c = torch.where(cache.tile_stop <= pair_hi, cache.tile_stop,
                             start_c)
        cache = cache._replace(raw_t=cache.raw_t[:, :pair_hi],
                               tile_start=start_c, tile_stop=stop_c)
    w2c = pose_matrix(pose_quat, pose_trans)
    q = quat_normalize(pose_quat)
    if pre_w2c is not None:
        w2c = pre_w2c @ w2c
        q = quat_multiply(rotmat_to_quat(pre_w2c[:3, :3])[None, :],
                          q[None, :])[0]
    cam_eye = cam_proj.replace_w2c(
        torch.eye(4, dtype=torch.float32, device=cache.raw_t.device))
    if opts.method == "3dgs":
        xyz_cam = cache.xyz_t.T @ w2c[:3, :3].T + w2c[:3, 3]
        quats_cam = quat_multiply(q[None, :], cache.quats_t.T).detach()
        pre = _preprocess_3dgs(xyz_cam, cache.scales_t.T, quats_cam,
                               cache.opac, cam_eye, opts)
        pattrs = pack_pair_attrs(pre, cache.rgb_t.T)
    else:
        xyz_cam_t = w2c[:3, :3] @ cache.xyz_t + w2c[:3, 3][:, None]
        quats_cam_t = quat_multiply_rows(q, cache.quats_t).detach()
        pattrs, _ = preprocess_t(xyz_cam_t, cache.scales_t, quats_cam_t,
                                 cache.opac, cache.rgb_t, cam_eye)
    if tile_ids is None:
        start, stop = cache.tile_start, cache.tile_stop
    else:
        ids = tile_ids.long()
        start, stop = cache.tile_start[ids], cache.tile_stop[ids]
    out = render_pairs(pattrs, start, stop, tile_ids,
                       opts.settings(need_normal=opts.normals_in_tracking))
    return _method_mask(out, opts)
