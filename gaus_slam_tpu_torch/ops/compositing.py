"""Chunk-parallel alpha-compositing math for the 2DGS rasterizer — the
plain PyTorch version of the per-block math of K1-K3
(port of gaus_slam_tpu/ops/compositing.py).

``composite_chunk`` composites one block of G depth-sorted pairs into a
per-pixel state. Work arrays are [..., G, P] (pairs on dim -2, pixels on
dim -1) with any leading batch dims, so the plain raster versions run
all tiles' k-th blocks in one call. Every ``lax.stop_gradient`` of the
JAX version is a ``.detach()`` at the same place; the CUDA kernels
(csrc/) implement the same function sequentially per pixel, and K2 its
hand-derived vjp with the same detach boundaries.

Semantics: the reference CUDA compositor with one documented deviation
(surface-aware depth fusion uses per-pair prefix sums of w * d_raw; see
the JAX module docstring).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .camera import ALPHA_MAX, ALPHA_MIN, FAR_N, FILTER_INV_SQUARE, NEAR_N, T_EPS

# Number of scalar attributes per pair (see preprocess.PAIR_FIELDS).
ATTR_C = 24
# Output channel layout of the tile-major render buffer.
OUT_FIELDS = (
    "r g b depth alpha nx ny nz middepth dist "
    "final_t m1 m2 n_contrib med_contrib done"
).split()
OUT_C = len(OUT_FIELDS)  # 16


class PixelState(NamedTuple):
    """Per-pixel compositing state; every field is [..., 1, P] float32."""

    T: torch.Tensor        # transmittance
    done: torch.Tensor     # sticky early-termination flag (0/1)
    r: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    D: torch.Tensor        # sum w * fused depth
    D2: torch.Tensor       # sum w * fused depth^2
    M1: torch.Tensor       # sum w * m          (non-sa distortion)
    M2: torch.Tensor       # sum w * m^2
    dist: torch.Tensor     # accumulated distortion (non-sa)
    mm: torch.Tensor       # median depth (raw depth at last T>0.5 crossing)
    n_contrib: torch.Tensor    # 1-based index of last accepted contributor
    med_contrib: torch.Tensor  # 1-based index of the median contributor


def init_state(P: int, batch: tuple = (), device="cpu",
               dtype=torch.float32) -> PixelState:
    z = torch.zeros(batch + (1, P), dtype=dtype, device=device)
    return PixelState(
        T=torch.ones_like(z), done=z, r=z, g=z, b=z,
        nx=z, ny=z, nz=z, D=z, D2=z, M1=z, M2=z, dist=z, mm=z,
        n_contrib=z, med_contrib=z,
    )


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    c = torch.cumsum(x, dim=-2)
    return torch.cat([torch.zeros_like(c[..., :1, :]), c[..., :-1, :]], dim=-2)


def composite_chunk(state: PixelState, attrs: torch.Tensor, px: torch.Tensor,
                    py: torch.Tensor, idx_base: torch.Tensor,
                    pair_valid: torch.Tensor, *, use_sa: bool,
                    need_normal: bool = True) -> PixelState:
    """Composite one chunk of G depth-sorted pairs into the pixel state.

    attrs [..., G, ATTR_C]; px, py [..., 1, P]; idx_base [..., 1, 1]
    (global 1-based in-tile index of attrs[0]); pair_valid [..., G, 1]."""
    f32 = torch.float32
    G = attrs.shape[-2]

    def col(i):
        return attrs[..., i:i + 1]  # [..., G, 1]

    a0x, a0y, a0z = col(0), col(1), col(2)
    a1x, a1y, a1z = col(3), col(4), col(5)
    a2x, a2y, a2z = col(6), col(7), col(8)
    twx, twy, twz = col(9), col(10), col(11)
    cx, cy = col(12), col(13)
    op = col(17)

    # ray-splat intersection: p = x*a0 + y*a1 + a2
    p_x = px * a0x + py * a1x + a2x
    p_y = px * a0y + py * a1y + a2y
    p_z = px * a0z + py * a1z + a2z
    pz_ok = p_z != 0.0
    pzf = pz_ok.to(f32)
    inv_pz = pzf / torch.where(pz_ok, p_z, torch.ones_like(p_z))
    sx = p_x * inv_pz
    sy = p_y * inv_pz
    rho3d = sx * sx + sy * sy
    dx = cx - px
    dy = cy - py
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    rho = torch.minimum(rho3d, rho2d)
    d3 = sx * twx + sy * twy + twz
    d_raw = torch.where(rho3d <= rho2d, d3, twz.expand_as(d3))

    gauss = torch.exp(-0.5 * rho)
    alpha_raw = op * gauss
    # min(alpha, 0.99) with pass-through gradient
    alpha_clamped = alpha_raw - torch.clamp(alpha_raw - ALPHA_MAX, min=0.0).detach()
    okf = (
        pzf
        * (d_raw >= NEAR_N).to(f32)
        * (alpha_raw >= ALPHA_MIN).to(f32)
        * pair_valid.to(f32)
        * (state.done < 0.5).to(f32)
    ).detach()
    alpha_eff = alpha_clamped * okf

    # the pixel stops before the first contributing pair whose inclusive
    # transmittance product drops below T_EPS
    log1ma = torch.log1p(-alpha_eff)
    cum_exc = _exclusive_cumsum(log1ma)
    T_in = state.T
    T_pref = T_in * torch.exp(cum_exc)
    belowf = ((T_pref * (1.0 - alpha_eff)).detach() < T_EPS).to(f32).detach()
    triggerf = okf * belowf
    af = okf * (1.0 - belowf)
    alpha_c = alpha_clamped * af
    w = alpha_c * T_pref
    T_out = T_in * torch.exp(torch.sum(log1ma * af, dim=-2, keepdim=True))

    gidx = (torch.arange(G, dtype=f32, device=attrs.device)[:, None]
            + idx_base.to(f32))  # [..., G, 1]

    # median: raw depth of the last accepted pair with T_pref > 0.5
    mcf = (af * (T_pref > 0.5).to(f32)).detach()
    med_idx = torch.amax(gidx * mcf, dim=-2, keepdim=True)
    has_med = med_idx > 0.0
    mm_new = torch.sum(d_raw * (gidx == med_idx).to(f32) * mcf, dim=-2,
                       keepdim=True)
    mm_out = torch.where(has_med, mm_new, state.mm)
    med_contrib_out = torch.maximum(state.med_contrib, med_idx)
    n_contrib_out = torch.maximum(
        state.n_contrib, torch.amax(gidx * af, dim=-2, keepdim=True))

    if use_sa:
        # surface-aware depth fusion at per-pair granularity; the fusion
        # weight conf and the depth statistics are detached
        wsg = w.detach()
        dsg = d_raw.detach()
        wd = wsg * dsg
        d_pref = state.D.detach() + _exclusive_cumsum(wd)
        d2_pref = state.D2.detach() + _exclusive_cumsum(wd * dsg)
        mm_tgt = mm_out.detach()
        t_sg = T_pref.detach()
        denom = torch.clamp(1.0 - t_sg, min=1e-12)
        exp_std = (d2_pref - 2.0 * d_pref * mm_tgt) / denom + mm_tgt * mm_tgt
        exp_std = torch.clamp(exp_std, min=1e-7)
        err = (mm_tgt - dsg) ** 2
        conf = torch.exp(-err / (4.0 * exp_std))
        conf = torch.where((t_sg > 0.5) | (d_pref <= 0.0),
                           torch.ones_like(conf), conf).detach()
        d_fused = conf * d_raw + (1.0 - conf) * mm_tgt
        dist_add = torch.zeros_like(state.dist)
        m1_add = torch.zeros_like(state.M1)
        m2_add = torch.zeros_like(state.M2)
    else:
        d_fused = d_raw
        m = FAR_N / (FAR_N - NEAR_N) * (1.0 - NEAR_N / torch.clamp(d_raw, min=1e-6))
        mw = m * w
        m2w = m * mw
        m1_pref = state.M1 + _exclusive_cumsum(mw)
        m2_pref = state.M2 + _exclusive_cumsum(m2w)
        A_pref = 1.0 - T_pref
        dist_add = torch.sum((m * m * A_pref + m2_pref - 2.0 * m * m1_pref) * w,
                             dim=-2, keepdim=True)
        m1_add = torch.sum(mw, dim=-2, keepdim=True)
        m2_add = torch.sum(m2w, dim=-2, keepdim=True)

    def acc(feat):  # [..., G, P] -> [..., 1, P]
        return torch.sum(feat * w, dim=-2, keepdim=True)

    # per-gaussian features: out[f, p] = sum_g feat[g, f] * w[g, p]
    feat = attrs[..., 18:21]
    if need_normal:
        feat = torch.cat([feat, attrs[..., 14:17]], dim=-1)
    facc = feat.transpose(-1, -2) @ w  # [..., 3 or 6, P]
    zrow = torch.zeros_like(facc[..., 0:1, :])

    done_out = torch.maximum(
        state.done, torch.amax(triggerf.detach(), dim=-2, keepdim=True))

    return PixelState(
        T=T_out, done=done_out,
        r=state.r + facc[..., 0:1, :], g=state.g + facc[..., 1:2, :],
        b=state.b + facc[..., 2:3, :],
        nx=state.nx + facc[..., 3:4, :] if need_normal else zrow,
        ny=state.ny + facc[..., 4:5, :] if need_normal else zrow,
        nz=state.nz + facc[..., 5:6, :] if need_normal else zrow,
        D=state.D + acc(d_fused), D2=state.D2 + acc(d_fused * d_fused),
        M1=state.M1 + m1_add, M2=state.M2 + m2_add,
        dist=state.dist + dist_add,
        mm=mm_out, n_contrib=n_contrib_out, med_contrib=med_contrib_out,
    )


def finalize(state: PixelState, bg: torch.Tensor, *, use_sa: bool) -> torch.Tensor:
    """Pixel state -> [..., OUT_C, P] output block. The median is detached
    inside the sa distortion output; the middepth output keeps it live."""
    T = state.T
    mm = state.mm
    mm_sg = mm.detach()
    geo_std = state.D2 - 2.0 * mm_sg * state.D + mm_sg * mm_sg * (1.0 - T)
    dist = geo_std if use_sa else state.dist
    rows = [
        state.r + T * bg[0], state.g + T * bg[1], state.b + T * bg[2],
        state.D, 1.0 - T,
        state.nx, state.ny, state.nz,
        mm, dist,
        T, state.M1, state.M2,
        state.n_contrib, state.med_contrib, state.done,
    ]
    return torch.cat(rows, dim=-2)
