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

``dtype=torch.bfloat16`` is the bf16 compute dtype of the JAX package
(``compositing.py:122-300`` there, ``tpu.compute_dtype = "bf16"``): the
per-pair [G, P] elementwise chain in bfloat16, the sums and the
``PixelState`` in float32. Every elementwise op computes in float32 from
its bf16 operands and rounds its result to bf16 (round to nearest even),
as torch does per op; the kernels' bf16 chain (csrc/raster_common.cuh,
``CT = BF16``, and its packed form in csrc/raster_bf16x2.cuh) rounds at
the same points:
  * inputs: the attributes and the pixel coordinates;
  * geometry, each op: p = x*a0 + y*a1 + a2 (two products, two sums),
    1/p_z, sx and sy (then clamped to +-bf16(1e4) = 9984), rho3d, the
    differences cx - x and cy - y, rho2d, d3, exp(-rho/2), op * gauss
    and the clamp's two subtractions against bf16(0.99);
  * per pair: log1p(-a), exp(cum) with cum (the float32 exclusive prefix
    sum of the bf16 log1p values) rounded first, bf16(T_in) * that,
    1 - a, T_pref * (1 - a) for the termination test, w = a * T_pref;
  * SA: w * d_raw and (w * d_raw) * d_raw, summed into the float32
    prefixes D and D2; 1 - T_pref; the fusion weight and the fused depth
    in float32 from those, and D, D2 add d_fused * w unrounded;
  * without SA: max(d_raw, bf16(1e-6)), bf16(0.2) / that, 1 - that,
    bf16(M_SCALE) * that (bf16(M_SCALE) = 1), m * w, m * (m * w),
    m * m, (m * m) * (1 - T_pref), 2 * m (exact); the distortion term's
    remaining products and sums in float32; D and D2 add the bf16
    products d_raw * w and (d_raw * d_raw) * w.
  * unrounded, float32: the prefix sums, T_out = T_in * exp(sum of the
    accepted log1p values), the colour and normal sums of attribute
    times w (exact float32 products of two bf16 values), the median and
    the contributor indices.
The constants that enter arithmetic are bf16 values (bf16(0.99),
bf16(0.2), bf16(1e-6), bf16(1e4), bf16(M_SCALE)), as the JAX chain's
weakly typed python scalars are; comparisons against ALPHA_MIN, NEAR_N,
T_EPS and 0.5 give the same answer for every bf16 value whichever of
the two roundings of the constant is used. The JAX chain blends floats
(``p * a + (1 - p) * b``) where this one selects: Mosaic could not lower
a bf16 select, and the two agree wherever the values are finite.
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
                    need_normal: bool = True,
                    dtype=torch.float32, f32_vjp: bool = False) -> PixelState:
    """Composite one chunk of G depth-sorted pairs into the pixel state.

    attrs [..., G, ATTR_C]; px, py [..., 1, P]; idx_base [..., 1, 1]
    (global 1-based in-tile index of attrs[0]); pair_valid [..., G, 1].
    ``dtype``: the compute dtype of the [G, P] chain, float32 or
    bfloat16 (module docstring). ``f32_vjp`` (bfloat16 only): the same
    forward values, differentiated in float32 as K2-bf16 does
    (_Bf16Values) instead of with bf16 cotangents."""
    if dtype == torch.bfloat16:
        return _composite_chunk_bf16(
            state, attrs, px, py, idx_base, pair_valid, use_sa=use_sa,
            need_normal=need_normal,
            ops=_Bf16Values if f32_vjp else _Bf16Tensors)
    if dtype != torch.float32:
        raise ValueError(f"compute dtype {dtype}: float32 or bfloat16")
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


# bf16 values of the constants that enter the bf16 chain's arithmetic
BF16_ALPHA_MAX = 0.98828125        # bf16(0.99)
BF16_NEAR_N = 0.2001953125         # bf16(0.2)
BF16_D_MIN = 2.0 ** -20 * 1.046875  # bf16(1e-6)
BF16_S_MAX = 9984.0                # bf16(1e4), the clamp of sx and sy
BF16_M_SCALE = 1.0                 # bf16(FAR_N / (FAR_N - NEAR_N))


class Bf16Geometry(NamedTuple):
    """The bf16 chain's per-(pair, pixel) geometry, [..., G, P]."""

    pz_ok: torch.Tensor
    rho3d: torch.Tensor
    rho2d: torch.Tensor
    d_raw: torch.Tensor
    alpha_raw: torch.Tensor
    alpha_clamped: torch.Tensor


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


class _RoundBf16(torch.autograd.Function):
    """x rounded to the nearest bf16 value; its derivative taken as 1."""

    @staticmethod
    def forward(ctx, x):
        return _round_bf16(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _ExpBf16(torch.autograd.Function):
    """bf16(exp(x)), differentiated at the rounded value."""

    @staticmethod
    def forward(ctx, x):
        y = _round_bf16(torch.exp(x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


class _RecipBf16(torch.autograd.Function):
    """bf16(1 / x), differentiated at the rounded value y: -y^2."""

    @staticmethod
    def forward(ctx, x):
        y = _round_bf16(1.0 / x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return -g * (y * y)


class _Bf16Tensors:
    """The bf16 chain on bfloat16 tensors: torch rounds each op's result,
    and torch.autograd each cotangent, as the JAX package's gradient of
    its bf16 chain does. ``r`` marks each rounding point of the chain (a
    no-op here: the bf16 op has rounded)."""

    dtype = torch.bfloat16

    @staticmethod
    def r(x):
        return x

    @staticmethod
    def cast(x):
        return x.to(torch.bfloat16)

    exp = staticmethod(torch.exp)

    @staticmethod
    def inv(ok, x):
        return ok.to(torch.bfloat16) / torch.where(ok, x, torch.ones_like(x))


class _Bf16Values:
    """The same chain on float32 tensors that hold its bf16 values: each
    op computes in float32 and ``r`` rounds its result, with the
    rounding's derivative taken as 1 and exp and 1/x differentiated at
    their rounded values. The same forward values as _Bf16Tensors; the
    gradient is K2-bf16's (csrc/raster_common.cuh::pair_grad): float32
    arithmetic on the rounded forward values."""

    dtype = torch.float32
    r = staticmethod(_RoundBf16.apply)

    @staticmethod
    def cast(x):
        return _RoundBf16.apply(x.to(torch.float32))

    exp = staticmethod(_ExpBf16.apply)

    @staticmethod
    def inv(ok, x):
        y = _RecipBf16.apply(torch.where(ok, x, torch.ones_like(x)))
        return torch.where(ok, y, torch.zeros_like(y))


def bf16_geometry(attrs: torch.Tensor, px: torch.Tensor,
                  py: torch.Tensor, ops=_Bf16Tensors) -> Bf16Geometry:
    """Ray-splat geometry and alpha of the bf16 chain from float32 attrs
    [..., G, ATTR_C] and pixel coordinates [..., 1, P] (both rounded to
    bf16 first); each op rounds its result to bf16. ``ops``: _Bf16Tensors
    (bfloat16 results) or _Bf16Values (float32 ones, the same values)."""
    R, a = ops.r, ops.cast(attrs)
    x, y = ops.cast(px), ops.cast(py)

    def c(v):  # a constant of the chain, a bf16 value
        return torch.tensor(v, dtype=ops.dtype, device=a.device)

    def col(i):
        return a[..., i:i + 1]

    def ray(i):  # x * a0 + y * a1 + a2, component i
        return R(R(R(x * col(i)) + R(y * col(i + 3))) + col(i + 6))

    p_x, p_y, p_z = ray(0), ray(1), ray(2)
    pz_ok = p_z != 0.0
    inv_pz = ops.inv(pz_ok, p_z)
    sx = torch.clamp(R(p_x * inv_pz), -BF16_S_MAX, BF16_S_MAX)
    sy = torch.clamp(R(p_y * inv_pz), -BF16_S_MAX, BF16_S_MAX)
    rho3d = R(R(sx * sx) + R(sy * sy))
    dx = R(col(12) - x)
    dy = R(col(13) - y)
    rho2d = R(FILTER_INV_SQUARE * R(R(dx * dx) + R(dy * dy)))
    rho = torch.minimum(rho3d, rho2d)
    d3 = R(R(R(sx * col(9)) + R(sy * col(10))) + col(11))
    d_raw = torch.where(rho3d <= rho2d, d3, col(11).expand_as(d3))
    gauss = ops.exp(R(-0.5 * rho))
    alpha_raw = R(col(17) * gauss)
    alpha_clamped = R(alpha_raw - R(torch.clamp(
        R(alpha_raw - c(BF16_ALPHA_MAX)), min=0.0)).detach())
    return Bf16Geometry(pz_ok, rho3d, rho2d, d_raw, alpha_raw, alpha_clamped)


def _composite_chunk_bf16(state, attrs, px, py, idx_base, pair_valid, *,
                          use_sa, need_normal, ops):
    """composite_chunk with the [G, P] chain in bf16 (module docstring);
    the same detach boundaries as the float32 chain. ``ops``: as
    bf16_geometry's."""
    f32, t, R = torch.float32, ops.dtype, ops.r
    G = attrs.shape[-2]
    g = bf16_geometry(attrs, px, py, ops)
    d_raw, alpha_raw, alpha_clamped = g.d_raw, g.alpha_raw, g.alpha_clamped

    def c(v):
        return torch.tensor(v, dtype=t, device=attrs.device)

    okf = (
        g.pz_ok.to(t)
        * (d_raw >= NEAR_N).to(t)
        * (alpha_raw >= ALPHA_MIN).to(t)
        * pair_valid.to(t)
        * (state.done < 0.5).to(t)
    ).detach()
    alpha_eff = R(alpha_clamped * okf)

    log1ma = R(torch.log1p(-alpha_eff))
    # float32 prefix sums of the bf16 values
    cum_exc = _exclusive_cumsum(log1ma.to(f32))
    T_in = state.T
    T_pref = R(ops.cast(T_in) * ops.exp(ops.cast(cum_exc)))
    belowf = (R(T_pref * R(1.0 - alpha_eff)).detach() < T_EPS).to(t).detach()
    triggerf = okf * belowf
    af = okf * (1.0 - belowf)
    alpha_c = R(alpha_clamped * af)
    w = R(alpha_c * T_pref)
    T_out = T_in * torch.exp(torch.sum((log1ma * af).to(f32), dim=-2,
                                       keepdim=True))

    gidx = (torch.arange(G, dtype=f32, device=attrs.device)[:, None]
            + idx_base.to(f32))

    mcf = (af.to(f32) * (T_pref > 0.5).to(f32)).detach()
    med_idx = torch.amax(gidx * mcf, dim=-2, keepdim=True)
    has_med = med_idx > 0.0
    mm_new = torch.sum(d_raw.to(f32) * (gidx == med_idx).to(f32) * mcf,
                       dim=-2, keepdim=True)
    mm_out = torch.where(has_med, mm_new, state.mm)
    med_contrib_out = torch.maximum(state.med_contrib, med_idx)
    n_contrib_out = torch.maximum(
        state.n_contrib, torch.amax(gidx * af.to(f32), dim=-2, keepdim=True))

    if use_sa:
        wsg = w.detach()
        dsg = d_raw.detach()
        wd = R(wsg * dsg)
        d_pref = state.D.detach() + _exclusive_cumsum(wd.to(f32))
        d2_pref = state.D2.detach() + _exclusive_cumsum(R(wd * dsg).to(f32))
        mm_tgt = mm_out.detach()
        t_sg = T_pref.detach()
        denom = R(torch.clamp(R(1.0 - t_sg), min=1e-12)).to(f32)
        exp_std = (d2_pref - 2.0 * d_pref * mm_tgt) / denom + mm_tgt * mm_tgt
        exp_std = torch.clamp(exp_std, min=1e-7)
        err = (mm_tgt - dsg.to(f32)) ** 2
        conf = torch.exp(-err / (4.0 * exp_std))
        conf = torch.where((t_sg > 0.5) | (d_pref <= 0.0),
                           torch.ones_like(conf), conf).detach()
        d_fused = conf * d_raw.to(f32) + (1.0 - conf) * mm_tgt
        w32 = w.to(f32)
        D_add = torch.sum(d_fused * w32, dim=-2, keepdim=True)
        D2_add = torch.sum(d_fused * d_fused * w32, dim=-2, keepdim=True)
        dist_add = torch.zeros_like(state.dist)
        m1_add = torch.zeros_like(state.M1)
        m2_add = torch.zeros_like(state.M2)
    else:
        d_cl = torch.clamp(d_raw, min=c(BF16_D_MIN))
        m = R(c(BF16_M_SCALE) * R(1.0 - R(torch.div(c(BF16_NEAR_N), d_cl))))
        mw = R(m * w)
        m2w = R(m * mw)
        m1_pref = state.M1 + _exclusive_cumsum(mw.to(f32))
        m2_pref = state.M2 + _exclusive_cumsum(m2w.to(f32))
        A_pref = R(1.0 - T_pref)
        dist_add = torch.sum(
            (R(R(m * m) * A_pref).to(f32) + m2_pref
             - R(2.0 * m).to(f32) * m1_pref) * w.to(f32),
            dim=-2, keepdim=True)
        m1_add = torch.sum(mw.to(f32), dim=-2, keepdim=True)
        m2_add = torch.sum(m2w.to(f32), dim=-2, keepdim=True)
        D_add = torch.sum(R(d_raw * w).to(f32), dim=-2, keepdim=True)
        D2_add = torch.sum(R(R(d_raw * d_raw) * w).to(f32), dim=-2,
                           keepdim=True)

    # colour and normal sums: float32 products of the bf16 values
    a_bf = ops.cast(attrs)
    feat = a_bf[..., 18:21]
    if need_normal:
        feat = torch.cat([feat, a_bf[..., 14:17]], dim=-1)
    facc = feat.to(f32).transpose(-1, -2) @ w.to(f32)
    zrow = torch.zeros_like(facc[..., 0:1, :])

    done_out = torch.maximum(
        state.done, torch.amax(triggerf.detach().to(f32), dim=-2, keepdim=True))

    return PixelState(
        T=T_out, done=done_out,
        r=state.r + facc[..., 0:1, :], g=state.g + facc[..., 1:2, :],
        b=state.b + facc[..., 2:3, :],
        nx=state.nx + facc[..., 3:4, :] if need_normal else zrow,
        ny=state.ny + facc[..., 4:5, :] if need_normal else zrow,
        nz=state.nz + facc[..., 5:6, :] if need_normal else zrow,
        D=state.D + D_add, D2=state.D2 + D2_add,
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
