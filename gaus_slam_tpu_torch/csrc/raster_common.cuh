// Per-pixel block math shared by the forward (K1/K3) and backward (K2)
// rasterizer kernels: one 128-pair block of a tile's depth-sorted pair
// range, composited sequentially for one pixel.
//
// This is ops/compositing.py::composite_chunk written per pixel and in
// pair order instead of as [128, 256] array math: the triangular-matmul
// prefix sums of the TPU version become running sums, and the SA median
// target (the block's final median) needs a second pass over the block.
// Every semantic choice of the JAX version is kept:
//   * 128-aligned global blocks with a validity mask (the caller);
//   * the 1-based in-tile contributor index idx_base + j;
//   * raw-depth prefix sums for SA's D and D2 statistics;
//   * a pair is accepted iff its inclusive product T_pref*(1-a) stays
//     >= T_EPS; `done` is sticky and read at the block start;
//   * the median is the raw depth of the last accepted pair with
//     T_pref > 0.5.
// T_pref is computed as T_in * exp(running sum of log1p(-a)), as the JAX
// kernel does, never by dividing by (1 - a).
//
// The library is compiled with -fmad=false: the backward kernel reruns
// composite_block from the stashed carry and must reproduce the forward
// kernel's values (and so its accept/terminate decisions) bit for bit.
//
// Everything above stage_block also compiles as plain C++ (GS_FN is
// `inline` there): csrc/pixel_math_host.cpp runs the same per-pixel math,
// range clamps and stash guards on the CPU so the CPU tests hold them to
// torch.autograd without a card.
#pragma once
#include <cstdint>
#include <math.h>
#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define GS_FN __device__ __forceinline__
#else
#define GS_FN inline
#endif

namespace gs {

constexpr int CHUNK = 128;   // pairs per block
constexpr int ATTR_C = 24;   // rows of the pair-attribute slab
constexpr int GRAD_C = 21;   // rows that can receive a gradient (0..20)
constexpr int OUT_C = 16;    // rows of the tile-major render buffer
constexpr int STASH_C = 8;   // T done D D2 M1 M2 mm pad
constexpr int TILE = 16;     // tile edge in pixels
constexpr int P = TILE * TILE;
// K5's re-forward visits at most this many blocks of a tile (64k pairs),
// as the TPU kernel's on-chip stash held (pallas_backward.py:48)
constexpr int MAX_CHUNKS_PER_TILE = 512;

// float32 roundings of the python constants (ops/camera.py), rounded
// from double exactly as numpy/JAX round them
constexpr float NEAR_N = (float)0.2;
constexpr float FILTER_INV_SQUARE = (float)100.0;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = (float)0.99;
constexpr float T_EPS = (float)1e-4;
constexpr float M_SCALE = (float)(100.0 / (100.0 - 0.2));  // FAR/(FAR-NEAR)

struct PixState {
  float T, done, r, g, b, nx, ny, nz, D, D2, M1, M2, dist, mm, nc, mc;
};

GS_FN PixState init_state() {
  PixState s;
  s.T = 1.f;
  s.done = s.r = s.g = s.b = s.nx = s.ny = s.nz = 0.f;
  s.D = s.D2 = s.M1 = s.M2 = s.dist = s.mm = s.nc = s.mc = 0.f;
  return s;
}

// Attribute c of block-local pair j; the block is staged as sa[c][j].
GS_FN float A(const float* sa, int c, int j) {
  return sa[c * CHUNK + j];
}

struct Geom {
  float p_x, p_y, p_z, inv_pz, sx, sy, rho3d, rho2d, dx, dy, d_raw, gauss;
  float alpha_raw, a_cl;
  bool pz_ok, use3d;
};

GS_FN void pair_geom(const float* sa, int j, float px,
                                          float py, Geom& g) {
  g.p_x = px * A(sa, 0, j) + py * A(sa, 3, j) + A(sa, 6, j);
  g.p_y = px * A(sa, 1, j) + py * A(sa, 4, j) + A(sa, 7, j);
  g.p_z = px * A(sa, 2, j) + py * A(sa, 5, j) + A(sa, 8, j);
  g.pz_ok = g.p_z != 0.f;
  g.inv_pz = (g.pz_ok ? 1.f : 0.f) / (g.pz_ok ? g.p_z : 1.f);
  g.sx = g.p_x * g.inv_pz;
  g.sy = g.p_y * g.inv_pz;
  g.rho3d = g.sx * g.sx + g.sy * g.sy;
  g.dx = A(sa, 12, j) - px;
  g.dy = A(sa, 13, j) - py;
  g.rho2d = FILTER_INV_SQUARE * (g.dx * g.dx + g.dy * g.dy);
  const float rho = fminf(g.rho3d, g.rho2d);
  const float d3 = g.sx * A(sa, 9, j) + g.sy * A(sa, 10, j) + A(sa, 11, j);
  g.use3d = g.rho3d <= g.rho2d;
  g.d_raw = g.use3d ? d3 : A(sa, 11, j);
  g.gauss = expf(-0.5f * rho);
  g.alpha_raw = A(sa, 17, j) * g.gauss;
  // min(alpha, 0.99) written as the JAX version writes it (the clamp's
  // gradient passes through)
  g.a_cl = g.alpha_raw - fmaxf(g.alpha_raw - ALPHA_MAX, 0.f);
}

GS_FN bool pair_ok(const Geom& g, bool valid, bool live) {
  return live && valid && g.pz_ok && g.d_raw >= NEAR_N &&
         g.alpha_raw >= ALPHA_MIN;
}

// SA fusion weight (detached in the gradient): conf of a pair with
// prefix transmittance t, exclusive raw-depth statistics (dp, d2p) and
// the block's median target mt.
GS_FN float sa_conf(float t, float dp, float d2p,
                                         float mt, float d_raw) {
  const float denom = fmaxf(1.f - t, (float)1e-12);
  float exp_std = (d2p - 2.f * dp * mt) / denom + mt * mt;
  exp_std = fmaxf(exp_std, (float)1e-7);
  const float e = mt - d_raw;
  const float conf = expf(-(e * e) / (4.f * exp_std));
  return (t > 0.5f || dp <= 0.f) ? 1.f : conf;
}

GS_FN float dist_m(float d_raw) {
  return M_SCALE * (1.f - NEAR_N / fmaxf(d_raw, (float)1e-6));
}

// What the backward needs from a block's forward recompute.
struct BlockInfo {
  float E;       // exp(sum of log1p(-a) over accepted pairs)
  float T_out;   // T_in * E
  float mm_out;  // median after the block (the SA target)
  int med_j;     // block-local index of the median pair, -1 if none
};

// Composite one block for one pixel, updating `s` as composite_chunk
// does. STORE records, per pair, the exclusive log-sum (cumx) and the
// exclusive statistics the backward needs (SA: D and D2 prefixes;
// non-SA: M1 and M2 prefixes).
template <bool USE_SA, bool NN, bool STORE>
GS_FN BlockInfo composite_block(
    PixState& s, const float* sa, int gstart, int start, int stop,
    float px, float py, float* cumx, float* pre1, float* pre2) {
  const float T_in = s.T;
  const bool live = s.done < 0.5f;
  const int idx_base = gstart - start + 1;
  float cum = 0.f, lsum = 0.f;
  float med_idx = 0.f, mm_new = 0.f, nc_blk = 0.f;
  int med_j = -1;
  bool trig = false;
  float racc = 0.f, gacc = 0.f, bacc = 0.f;
  float nxacc = 0.f, nyacc = 0.f, nzacc = 0.f;
  float Dacc = 0.f, D2acc = 0.f;
  float M1p = s.M1, M2p = s.M2, dist_add = 0.f, m1_add = 0.f, m2_add = 0.f;
  float dp = s.D, d2p = s.D2;
#pragma unroll 1
  for (int j = 0; j < CHUNK; ++j) {
    const int gi = gstart + j;
    Geom g;
    pair_geom(sa, j, px, py, g);
    const bool okf = pair_ok(g, gi >= start && gi < stop, live);
    const float a_eff = okf ? g.a_cl : 0.f;
    const float l = log1pf(-a_eff);
    const float T_pref = T_in * expf(cum);
    if (STORE) cumx[j] = cum;
    cum = cum + l;
    const bool below = T_pref * (1.f - a_eff) < T_EPS;
    const bool af = okf && !below;
    trig = trig || (okf && below);
    const float w = af ? g.a_cl * T_pref : 0.f;
    if (USE_SA) {
      if (STORE) { pre1[j] = dp; pre2[j] = d2p; }
      const float wd = w * g.d_raw;
      dp = dp + wd;
      d2p = d2p + wd * g.d_raw;
    } else {
      if (STORE) { pre1[j] = M1p; pre2[j] = M2p; }
    }
    if (!af) continue;
    lsum = lsum + l;
    const float gidx = (float)(idx_base + j);
    if (T_pref > 0.5f) { med_idx = gidx; mm_new = g.d_raw; med_j = j; }
    nc_blk = gidx;
    racc = racc + A(sa, 18, j) * w;
    gacc = gacc + A(sa, 19, j) * w;
    bacc = bacc + A(sa, 20, j) * w;
    if (NN) {
      nxacc = nxacc + A(sa, 14, j) * w;
      nyacc = nyacc + A(sa, 15, j) * w;
      nzacc = nzacc + A(sa, 16, j) * w;
    }
    if (!USE_SA) {
      const float m = dist_m(g.d_raw);
      const float mw = m * w;
      const float m2w = m * mw;
      dist_add = dist_add + (m * m * (1.f - T_pref) + M2p - 2.f * m * M1p) * w;
      M1p = M1p + mw;
      M2p = M2p + m2w;
      m1_add = m1_add + mw;
      m2_add = m2_add + m2w;
      Dacc = Dacc + g.d_raw * w;
      D2acc = D2acc + g.d_raw * g.d_raw * w;
    }
  }
  BlockInfo bi;
  bi.E = expf(lsum);
  bi.T_out = T_in * bi.E;
  bi.mm_out = med_idx > 0.f ? mm_new : s.mm;
  bi.med_j = med_idx > 0.f ? med_j : -1;

  if (USE_SA && !STORE) {
    // second pass: the fusion weights need the block's final median
    const float mt = bi.mm_out;
    cum = 0.f;
    dp = s.D;
    d2p = s.D2;
#pragma unroll 1
    for (int j = 0; j < CHUNK; ++j) {
      const int gi = gstart + j;
      Geom g;
      pair_geom(sa, j, px, py, g);
      const bool okf = pair_ok(g, gi >= start && gi < stop, live);
      const float a_eff = okf ? g.a_cl : 0.f;
      const float l = log1pf(-a_eff);
      const float T_pref = T_in * expf(cum);
      cum = cum + l;
      const bool af = okf && !(T_pref * (1.f - a_eff) < T_EPS);
      const float w = af ? g.a_cl * T_pref : 0.f;
      if (af) {
        const float conf = sa_conf(T_pref, dp, d2p, mt, g.d_raw);
        const float df = conf * g.d_raw + (1.f - conf) * mt;
        Dacc = Dacc + df * w;
        D2acc = D2acc + df * df * w;
      }
      const float wd = w * g.d_raw;
      dp = dp + wd;
      d2p = d2p + wd * g.d_raw;
    }
  }

  s.T = bi.T_out;
  s.done = fmaxf(s.done, trig ? 1.f : 0.f);
  s.r = s.r + racc;
  s.g = s.g + gacc;
  s.b = s.b + bacc;
  s.nx = NN ? s.nx + nxacc : 0.f;
  s.ny = NN ? s.ny + nyacc : 0.f;
  s.nz = NN ? s.nz + nzacc : 0.f;
  s.D = s.D + Dacc;
  s.D2 = s.D2 + D2acc;
  if (!USE_SA) {
    s.M1 = s.M1 + m1_add;
    s.M2 = s.M2 + m2_add;
    s.dist = s.dist + dist_add;
  }
  s.mm = bi.mm_out;
  s.nc = fmaxf(s.nc, nc_blk);
  s.mc = fmaxf(s.mc, med_idx);
  return bi;
}

// Cotangent of one pixel's state, in PixelState field order (done,
// n_contrib and med_contrib carry none).
struct Cot {
  float T, r, g, b, nx, ny, nz, D, D2, M1, M2, dist, mm;
};

// Suffix accumulators of the reverse walk over one block.
struct RevCarry {
  float U;     // sum over later pairs of dL/dT_pref * T_pref
  float S_w;   // sum over later accepted pairs of w
  float S_wm;  // sum over later accepted pairs of w * m
  float gTin;  // sum over visited pairs of dL/dT_pref * exp(cumx)
};

// Hand-derived vjp of composite_block for pair j of one pixel, visited
// in reverse pair order. T_in / live are the block's incoming state,
// cumx / pre1 / pre2 / bi the records of its forward recompute. Writes
// the pixel's contribution to the 21 attribute gradients into gv and
// returns whether the pair touched the pixel at all (okf); a pair that
// did not contributes exactly zero.
template <bool USE_SA, bool NN>
GS_FN bool pair_grad(const float* sa, int j, int gi, int start, int stop,
                     float px, float py, float T_in, bool live,
                     const BlockInfo& bi, const Cot& c, const float* cumx,
                     const float* pre1, const float* pre2, RevCarry& rc,
                     float* gv) {
  for (int q = 0; q < GRAD_C; ++q) gv[q] = 0.f;
  Geom g;
  pair_geom(sa, j, px, py, g);
  if (!pair_ok(g, gi >= start && gi < stop, live)) return false;
  const float a_eff = g.a_cl;
  const float e = expf(cumx[j]);
  const float T_pref = T_in * e;
  const bool af = !(T_pref * (1.f - a_eff) < T_EPS);
  const float w = af ? g.a_cl * T_pref : 0.f;
  float g_acl = 0.f, g_draw = 0.f, g_Tpref = 0.f;
  if (af) {
    // w = a_cl * T_pref feeds colors, normals, D, D2 (and M1, M2, dist)
    float g_w = c.r * A(sa, 18, j) + c.g * A(sa, 19, j) + c.b * A(sa, 20, j);
    if (NN) g_w += c.nx * A(sa, 14, j) + c.ny * A(sa, 15, j) + c.nz * A(sa, 16, j);
    if (USE_SA) {
      // d_fused = conf*d_raw + (1-conf)*mm_tgt, conf and mm_tgt detached
      const float conf = sa_conf(T_pref, pre1[j], pre2[j], bi.mm_out, g.d_raw);
      const float df = conf * g.d_raw + (1.f - conf) * bi.mm_out;
      g_w += c.D * df + c.D2 * (df * df);
      g_draw += conf * (c.D * w + 2.f * c.D2 * df * w);
    } else {
      const float d = g.d_raw;
      g_w += c.D * d + c.D2 * (d * d);
      g_draw += c.D * w + 2.f * c.D2 * d * w;
      // dist = sum_i (m_i^2 A_i + M2p_i - 2 m_i M1p_i) w_i with the
      // exclusive prefixes M1p, M2p and A_i = 1 - T_pref_i (all live)
      const float m = dist_m(d);
      const float Ap = 1.f - T_pref;
      const float M1p = pre1[j], M2p = pre2[j];
      g_w += c.M1 * m + c.M2 * (m * m)
             + c.dist * (m * m * Ap + M2p - 2.f * m * M1p)
             + c.dist * (m * m * rc.S_w - 2.f * m * rc.S_wm);
      const float g_m = w * (c.M1 + 2.f * m * c.M2
                             + 2.f * c.dist * (m * Ap - M1p + m * rc.S_w - rc.S_wm));
      g_Tpref -= c.dist * m * m * w;
      if (d > (float)1e-6) g_draw += g_m * M_SCALE * NEAR_N / (d * d);
      rc.S_w += w;
      rc.S_wm += w * m;
    }
    // the middepth output is the raw depth of the median pair (live)
    if (j == bi.med_j) g_draw += c.mm;
    g_Tpref += g_w * g.a_cl;
    g_acl = g_w * T_pref;
    gv[18] = w * c.r;
    gv[19] = w * c.g;
    gv[20] = w * c.b;
    if (NN) { gv[14] = w * c.nx; gv[15] = w * c.ny; gv[16] = w * c.nz; }
  }
  // l = log1p(-a_eff) feeds every later pair's T_pref and, if this pair
  // was accepted, T_out = T_in * exp(sum of accepted l)
  const float g_l = rc.U + (af ? c.T * bi.T_out : 0.f);
  g_acl += -g_l / (1.f - a_eff);
  rc.U += g_Tpref * T_pref;
  rc.gTin += g_Tpref * e;

  // alpha_raw = op * exp(-rho / 2), rho = min(rho3d, rho2d); the clamp
  // to ALPHA_MAX passes its gradient through, ties split it evenly
  const float g_ar = g_acl;
  gv[17] = g_ar * g.gauss;
  const float g_rho = (g_ar * A(sa, 17, j)) * g.gauss * -0.5f;
  float g3, g2;
  if (g.rho3d < g.rho2d) { g3 = g_rho; g2 = 0.f; }
  else if (g.rho2d < g.rho3d) { g3 = 0.f; g2 = g_rho; }
  else { g3 = 0.5f * g_rho; g2 = 0.5f * g_rho; }
  float g_sx = 2.f * g.sx * g3;
  float g_sy = 2.f * g.sy * g3;
  // d_raw = rho3d <= rho2d ? sx*twx + sy*twy + twz : twz
  if (g.use3d) {
    g_sx += A(sa, 9, j) * g_draw;
    g_sy += A(sa, 10, j) * g_draw;
    gv[9] = g.sx * g_draw;
    gv[10] = g.sy * g_draw;
  }
  gv[11] = g_draw;
  // rho2d = 100 * ((cx - px)^2 + (cy - py)^2)
  gv[12] = FILTER_INV_SQUARE * 2.f * g.dx * g2;
  gv[13] = FILTER_INV_SQUARE * 2.f * g.dy * g2;
  // (sx, sy) = (p_x, p_y) / p_z, p = px*a0 + py*a1 + a2
  const float g_px = g.inv_pz * g_sx;
  const float g_py = g.inv_pz * g_sy;
  const float g_inv = g.p_x * g_sx + g.p_y * g_sy;
  const float g_pz = g.pz_ok ? -g_inv * g.inv_pz * g.inv_pz : 0.f;
  gv[0] = px * g_px; gv[1] = px * g_py; gv[2] = px * g_pz;
  gv[3] = py * g_px; gv[4] = py * g_py; gv[5] = py * g_pz;
  gv[6] = g_px; gv[7] = g_py; gv[8] = g_pz;
  return true;
}

// Cotangent of the block's incoming state from the outgoing one: the
// carry for the previous block.
template <bool USE_SA, bool NN>
GS_FN void carry_cotangent(Cot& c, const BlockInfo& bi, const RevCarry& rc) {
  c.T = c.T * bi.E + rc.gTin;
  if (!USE_SA) {
    c.M1 = c.M1 - 2.f * c.dist * rc.S_wm;
    c.M2 = c.M2 + c.dist * rc.S_w;
  }
  if (bi.med_j >= 0) c.mm = 0.f;
  if (!NN) { c.nx = 0.f; c.ny = 0.f; c.nz = 0.f; }
}

// Cotangent from the [OUT_C, P] rows of finalize_cotangents.
GS_FN Cot load_cot(const float* d0, int stride) {
  Cot c;
  c.T = d0[0 * stride];
  c.r = d0[2 * stride]; c.g = d0[3 * stride]; c.b = d0[4 * stride];
  c.nx = d0[5 * stride]; c.ny = d0[6 * stride]; c.nz = d0[7 * stride];
  c.D = d0[8 * stride]; c.D2 = d0[9 * stride];
  c.M1 = d0[10 * stride]; c.M2 = d0[11 * stride]; c.dist = d0[12 * stride];
  c.mm = d0[13 * stride];
  return c;
}

// PixState holding a block's incoming carry from its stash row.
GS_FN PixState state_from_stash(const float* row, int stride) {
  PixState s = init_state();
  s.T = row[0 * stride];
  s.done = row[1 * stride];
  s.D = row[2 * stride];
  s.D2 = row[3 * stride];
  s.M1 = row[4 * stride];
  s.M2 = row[5 * stride];
  s.mm = row[6 * stride];
  return s;
}

// A block's incoming carry, as state_from_stash reads it back.
GS_FN void store_stash(float* row, int stride, const PixState& s) {
  row[0 * stride] = s.T;
  row[1 * stride] = s.done;
  row[2 * stride] = s.D;
  row[3 * stride] = s.D2;
  row[4 * stride] = s.M1;
  row[5 * stride] = s.M2;
  row[6 * stride] = s.mm;
  row[7 * stride] = 0.f;
}

// The finalized pixel (background 0), rows as compositing.OUT_FIELDS.
template <bool USE_SA>
GS_FN void store_out(float* o, int stride, const PixState& s) {
  const float dist = USE_SA
      ? s.D2 - 2.f * s.mm * s.D + s.mm * s.mm * (1.f - s.T)
      : s.dist;
  const float v[OUT_C] = {s.r, s.g, s.b, s.D, 1.f - s.T, s.nx, s.ny, s.nz,
                          s.mm, dist, s.T, s.M1, s.M2, s.nc, s.mc, s.done};
#pragma unroll
  for (int c = 0; c < OUT_C; ++c) o[c * stride] = v[c];
}

// A tile's walk over the slab: its pair range clamped to [0, R], so no
// read or write leaves the slab, and the 128-aligned global blocks
// floor(start/128) .. ceil(stop/128) that cover it.
struct TileWalk {
  int start, stop, blk0, nblk;
};

GS_FN TileWalk tile_walk(int tstart, int tstop, int R) {
  TileWalk w;
  w.start = tstart > 0 ? tstart : 0;
  w.stop = tstop < R ? tstop : R;
  w.blk0 = w.start / CHUNK;
  w.nblk = w.stop > w.start ? (w.stop + CHUNK - 1) / CHUNK - w.blk0 : 0;
  return w;
}

// Blocks the reverse sweep visits: the forward's kexit, clamped to the
// tile's blocks and to the stash rows [soff, stash_rows) it owns.
GS_FN int swept_blocks(int kexit, int nblk, int soff, int stash_rows) {
  const int k = kexit < nblk ? kexit : nblk;
  return k < stash_rows - soff ? k : stash_rows - soff;
}

// Blocks K5's re-forward may visit: the tile's, capped at
// MAX_CHUNKS_PER_TILE.
GS_FN int reforward_blocks(int nblk) {
  return nblk < MAX_CHUNKS_PER_TILE ? nblk : MAX_CHUNKS_PER_TILE;
}

// Image coordinates of pixel p of tile t.
GS_FN float pixel_x(int t, int tiles_x, int p) {
  return (float)((t % tiles_x) * TILE + p % TILE);
}

GS_FN float pixel_y(int t, int tiles_x, int p) {
  return (float)((t / tiles_x) * TILE + p / TILE);
}

#if defined(__CUDACC__)
// Stage block b of the [ATTR_C, R] slab into shared memory as sa[c][j].
__device__ __forceinline__ void stage_block(float* sa, const float* attrs,
                                            int64_t R, int64_t gstart) {
  for (int e = threadIdx.x; e < ATTR_C * CHUNK; e += blockDim.x) {
    const int c = e / CHUNK, j = e % CHUNK;
    sa[e] = attrs[c * R + gstart + j];
  }
}

// One CTA's forward walk over the first `nblk` blocks of its tile, from
// the pixel state `s` (K1, K3, and K5's re-forward): each block staged
// once in `sa`, every pixel compositing it; the walk stops once every
// pixel of the tile has terminated. With STASH, each block's incoming
// carry goes to stash row soff + k (rows past stash_rows are skipped).
// Returns the number of blocks composited.
template <bool STASH, bool USE_SA, bool NN>
__device__ __forceinline__ int forward_walk(
    PixState& s, float* sa, const float* __restrict__ attrs, int R,
    const TileWalk& tw, int nblk, float px, float py, float* stash,
    int soff, int stash_rows) {
  const int p = threadIdx.x;
  int k = 0;
  for (; k < nblk; ++k) {
    // exit once every pixel of the tile has terminated (this barrier
    // also orders the previous block's reads of `sa` before the restage)
    if (__syncthreads_and(s.done >= 0.5f)) break;
    const int64_t gstart = (int64_t)(tw.blk0 + k) * CHUNK;
    if (STASH && soff + k < stash_rows)
      store_stash(stash + ((int64_t)(soff + k) * STASH_C) * P + p, P, s);
    stage_block(sa, attrs, R, gstart);
    __syncthreads();
    composite_block<USE_SA, NN, false>(s, sa, (int)gstart, tw.start, tw.stop,
                                       px, py, nullptr, nullptr, nullptr);
  }
  return k;
}
#endif

}  // namespace gs
