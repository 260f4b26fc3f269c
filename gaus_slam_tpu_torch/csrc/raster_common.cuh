// Per-pixel block math shared by the forward (K1/K3) and backward (K2)
// rasterizer kernels: one 128-pair block of a tile's depth-sorted pair
// range, composited sequentially for one pixel.
//
// This is ops/compositing.py::composite_chunk written per pixel and in
// pair order instead of as [128, 256] array math: the triangular-matmul
// prefix sums of the TPU version become running sums, and the SA median
// target (the block's final median) needs a second pass, over the pairs
// the first one found touching the pixel (its step mask).
// Every semantic choice of the JAX version is kept:
//   * 128-aligned global blocks, of which only the pairs in the tile's
//     range are walked (the JAX version masks the others: a masked pair of
//     finite depth moves nothing);
//   * the 1-based in-tile contributor index idx_base + j;
//   * raw-depth prefix sums for SA's D and D2 statistics;
//   * a pair is accepted iff its inclusive product T_pref*(1-a) stays
//     >= T_EPS; `done` is sticky and read at the block start;
//   * the median is the raw depth of the last accepted pair with
//     T_pref > 0.5.
// T_pref is computed as T_in * exp(running sum of log1p(-a)), as the JAX
// kernel does, never by dividing by (1 - a).
//
// The library is compiled with -fmad=false: the backward kernel re-walks
// each block from the stashed carry through the same pair_step and must
// reproduce the forward kernel's values (and so its accept/terminate
// decisions) bit for bit. The backward's own vjp arithmetic (pair_grad,
// carry_cotangent) needs no such match and fuses its multiply-adds with
// explicit fmaf, which -fmad=false leaves alone.
//
// Everything above stage_block also compiles as plain C++ (GS_FN is
// `inline` there): csrc/pixel_math_host.cpp runs the same per-pixel math,
// range clamps and stash guards on the CPU so the CPU tests hold them to
// torch.autograd without a card.
//
// The compute type CT of the per-pair chain (tpu.compute_dtype) is a
// template parameter of every function of the walk: F32, or BF16, which
// is the JAX package's bf16 compute dtype (compositing.py's bf16 branch
// there). BF16 rounds the result of each op of the chain to bf16 (round
// to nearest even), at the points ops/compositing.py's docstring lists;
// the sums, the pixel state and the vjp stay float32. Here BF16 is the
// one-pixel form: each op in float32 from bf16 values, then CT::r. The
// kernels run the same chain packed, two pixels a thread in the lanes of
// a bf16x2 word (raster_bf16x2.cuh): an add, sub or mul of two bf16
// values rounded once to bf16 equals the float32 op rounded to bf16
// (float32 holds 24 >= 2 * 8 + 2 bits, so the double rounding is
// innocuous), so the packed chain gives this one's bits. Neither ever
// fuses a bf16 multiply-add (__hfma fuses where the chain rounds twice),
// so K2's recompute repeats K1's bf16 values bit for bit as it does in
// F32. F32's r is the identity: its instantiation computes what it did
// before CT existed, bit for bit.
#pragma once
#include <cstdint>
#include <cstring>
#include <math.h>
#if defined(__CUDACC__)
#include <cuda_bf16.h>
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

// float -> nearest bf16 (ties to even), as a float: cvt.rn.bf16.f32 on
// the card; on the host the same rounding of the bits (PyTorch's, and
// __float2bfloat16_rn's: a NaN stays a NaN, an overflow goes to inf).
GS_FN float bf16_round(float x) {
#if defined(__CUDA_ARCH__)
  return __bfloat162float(__float2bfloat16_rn(x));
#else
  uint32_t u;
  std::memcpy(&u, &x, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u) return x;
  u = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
  std::memcpy(&x, &u, sizeof x);
  return x;
#endif
}

// The compute types. r rounds an op's result; stage makes the word that
// a block's attribute is staged as, and attr reads staged word i back as
// the chain's operand; the constants are those the chain's arithmetic
// reads (bf16 values under BF16, as the JAX chain reads its python
// scalars); comparisons use the float32 constants above, which give the
// same answer for every bf16 value.
struct F32 {
  static constexpr bool IS_BF16 = false;
  static GS_FN float r(float x) { return x; }
  static GS_FN float stage(float x) { return x; }
  static GS_FN float attr(const float* sa, int i) { return sa[i]; }
  static constexpr float ALPHA_MAX = gs::ALPHA_MAX;
  static constexpr float NEAR = NEAR_N;
  static constexpr float M_SCALE = gs::M_SCALE;
  static constexpr float D_MIN = (float)1e-6;
  static constexpr float DENOM_MIN = (float)1e-12;
};

struct BF16 {
  static constexpr bool IS_BF16 = true;
  static GS_FN float r(float x) { return bf16_round(x); }
  // the block is staged in float32 and rounded as it is read
  static GS_FN float stage(float x) { return x; }
  static GS_FN float attr(const float* sa, int i) { return r(sa[i]); }
  static constexpr float ALPHA_MAX = 0.98828125f;          // bf16(0.99)
  static constexpr float NEAR = 0.2001953125f;             // bf16(0.2)
  static constexpr float M_SCALE = 1.0f;                   // bf16(M_SCALE)
  static constexpr float D_MIN = 9.98377799987793e-07f;    // bf16(1e-6)
  static constexpr float DENOM_MIN = 1.0018652574217413e-12f;  // bf16(1e-12)
  static constexpr float S_MAX = 9984.0f;                  // bf16(1e4)
};

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

// Attribute c of block-local pair j; the block is staged as sa[c][j]
// (CT::attr reads it).
template <class CT = F32>
GS_FN float A(const float* sa, int c, int j) {
  return CT::attr(sa, c * CHUNK + j);
}

struct Geom {
  float p_x, p_y, p_z, inv_pz, sx, sy, rho3d, rho2d, dx, dy, d_raw, gauss;
  float alpha_raw, a_cl;
  bool pz_ok, use3d;
  bool clx, cly;  // BF16: sx / sy clamped to +-S_MAX (no gradient through)
};

// Under BF16, px and py are the bf16-rounded pixel coordinates.
template <class CT>
GS_FN void pair_geom(const float* sa, int j, float px,
                                          float py, Geom& g) {
  const auto r = [](float x) { return CT::r(x); };
  g.p_x = r(r(r(px * A<CT>(sa, 0, j)) + r(py * A<CT>(sa, 3, j))) +
            A<CT>(sa, 6, j));
  g.p_y = r(r(r(px * A<CT>(sa, 1, j)) + r(py * A<CT>(sa, 4, j))) +
            A<CT>(sa, 7, j));
  g.p_z = r(r(r(px * A<CT>(sa, 2, j)) + r(py * A<CT>(sa, 5, j))) +
            A<CT>(sa, 8, j));
  g.pz_ok = g.p_z != 0.f;
  g.inv_pz = r((g.pz_ok ? 1.f : 0.f) / (g.pz_ok ? g.p_z : 1.f));
  g.sx = r(g.p_x * g.inv_pz);
  g.sy = r(g.p_y * g.inv_pz);
  g.clx = g.cly = false;
  if (CT::IS_BF16) {
    // the JAX bf16 chain clamps sx, sy (compositing.py:159-160 there); a
    // NaN stays a NaN, as through clip
    g.clx = fabsf(g.sx) > BF16::S_MAX;
    g.cly = fabsf(g.sy) > BF16::S_MAX;
    if (g.clx) g.sx = copysignf(BF16::S_MAX, g.sx);
    if (g.cly) g.sy = copysignf(BF16::S_MAX, g.sy);
  }
  g.rho3d = r(r(g.sx * g.sx) + r(g.sy * g.sy));
  g.dx = r(A<CT>(sa, 12, j) - px);
  g.dy = r(A<CT>(sa, 13, j) - py);
  g.rho2d = r(FILTER_INV_SQUARE * r(r(g.dx * g.dx) + r(g.dy * g.dy)));
  const float rho = fminf(g.rho3d, g.rho2d);
  const float d3 = r(r(r(g.sx * A<CT>(sa, 9, j)) + r(g.sy * A<CT>(sa, 10, j))) +
                     A<CT>(sa, 11, j));
  g.use3d = g.rho3d <= g.rho2d;
  g.d_raw = g.use3d ? d3 : A<CT>(sa, 11, j);
  g.gauss = r(expf(-0.5f * rho));
  g.alpha_raw = r(A<CT>(sa, 17, j) * g.gauss);
  // min(alpha, 0.99) written as the JAX version writes it (the clamp's
  // gradient passes through)
  g.a_cl = r(g.alpha_raw - r(fmaxf(r(g.alpha_raw - CT::ALPHA_MAX), 0.f)));
}

GS_FN bool pair_ok(const Geom& g, bool valid, bool live) {
  return live && valid && g.pz_ok && g.d_raw >= NEAR_N &&
         g.alpha_raw >= ALPHA_MIN;
}

// SA fusion weight (detached in the gradient): conf of a pair with
// prefix transmittance t, exclusive raw-depth statistics (dp, d2p) and
// the block's median target mt.
template <class CT>
GS_FN float sa_conf(float t, float dp, float d2p,
                                         float mt, float d_raw) {
  const float denom = fmaxf(CT::r(1.f - t), CT::DENOM_MIN);
  float exp_std = (d2p - 2.f * dp * mt) / denom + mt * mt;
  exp_std = fmaxf(exp_std, (float)1e-7);
  const float e = mt - d_raw;
  const float conf = expf(-(e * e) / (4.f * exp_std));
  return (t > 0.5f || dp <= 0.f) ? 1.f : conf;
}

template <class CT>
GS_FN float dist_m(float d_raw) {
  const auto r = [](float x) { return CT::r(x); };
  return r(CT::M_SCALE * r(1.f - r(CT::NEAR / fmaxf(d_raw, CT::D_MIN))));
}

// The walks stage, in the slab's first pad row, each pair's cull
// radius: the rho beyond which op * exp(-rho / 2) < ALPHA_MIN, widened
// by a relative and an absolute 2^-10, far above float rounding; -1 for
// a pair that no pixel can accept (op < ALPHA_MIN; exp(-rho / 2) <= 1).
// Under BF16 the radius is that of the bf16 opacity op_b against the
// chain's rounded alpha: a pair passes only if bf16(op_b * g) >=
// ALPHA_MIN with g = bf16(exp(-rho / 2)); each of the two roundings takes
// at most 2^-8 relative, so passing needs exp(-rho / 2) >= ALPHA_MIN /
// (op_b (1 + 2^-8)^2), rho <= 2 ln(op_b / ALPHA_MIN) + 0.0157: the
// absolute margin is 2^-5. op_b < ALPHA_MIN passes nowhere (g <= 1).
constexpr int RHO_ROW = GRAD_C;

template <class CT>
GS_FN float rho_cull(float op) {
  const float m = 1.f / 1024.f;
  if (CT::IS_BF16) {
    const float ob = CT::r(op);
    return ob < ALPHA_MIN ? -1.f
                          : 2.f * logf(ob / ALPHA_MIN) * (1.f + m) + 1.f / 32.f;
  }
  return op < ALPHA_MIN ? -1.f : 2.f * logf(op / ALPHA_MIN) * (1.f + m) + m;
}

// Whether pair j surely fails pixel (px, py)'s alpha test: both of its
// squared distances exceed the cull radius. The 3D one is compared as
// p_x^2 + p_y^2 > lim * p_z^2, without the division; NaN compares false,
// so a pair with NaN in it is never culled. A culled pair has okf false;
// it leaves Run as it was (SA's prefixes add 0 * d_raw, which is 0
// whenever the pair's geometry is finite), so the first pass (K1's and
// the backward's) skips its geometry altogether.
// Under BF16 the rounding of the coordinates and of every op of the
// chain moves rho by far more than the f32 radius's margin (a pixel
// coordinate past 256 rounds to an even number), so the test compares the
// chain's own rounded rho2d, then rho3d (pair_geom's values, bit for bit),
// with the bf16 radius: the cull is exact up to that radius's margin, and
// culls only what the chain's own alpha test rejects.
template <class CT>
GS_FN bool pair_culled(const float* sa, int j, float px, float py) {
  const float lim = sa[RHO_ROW * CHUNK + j];
  if (CT::IS_BF16) {
    const auto r = [](float x) { return CT::r(x); };
    const float dx = r(A<CT>(sa, 12, j) - px);
    const float dy = r(A<CT>(sa, 13, j) - py);
    if (!(r(FILTER_INV_SQUARE * r(r(dx * dx) + r(dy * dy))) > lim))
      return false;
    Geom g;
    pair_geom<CT>(sa, j, px, py, g);
    return g.rho3d > lim;
  }
  const float dx = A(sa, 12, j) - px;
  const float dy = A(sa, 13, j) - py;
  if (!(FILTER_INV_SQUARE * (dx * dx + dy * dy) > lim)) return false;
  const float p_x = px * A(sa, 0, j) + py * A(sa, 3, j) + A(sa, 6, j);
  const float p_y = px * A(sa, 1, j) + py * A(sa, 4, j) + A(sa, 7, j);
  const float p_z = px * A(sa, 2, j) + py * A(sa, 5, j) + A(sa, 8, j);
  return p_x * p_x + p_y * p_y > lim * (p_z * p_z);
}

// Whether the forward walk skips work that cannot change a value: a pixel
// that is done at the block start, a pair the cull rejects, a pixel that
// triggered, and SA's second pass outside the step mask (composite_block
// argues each). The CPU tests also build the host math with
// -DGS_FWD_NO_SKIP, which turns every one of them off, and require the
// same bits.
#ifdef GS_FWD_NO_SKIP
constexpr bool FWD_SKIP = false;
#else
constexpr bool FWD_SKIP = true;
#endif

// What the backward needs from a block's forward recompute.
struct BlockInfo {
  float E;       // exp(sum of log1p(-a) over accepted pairs)
  float T_out;   // T_in * E
  float mm_out;  // median after the block (the SA target)
  int med_j;     // block-local index of the median pair, -1 if none
};

// The running values of a block's walk for one pixel, exclusive of the
// next pair: the log-sum of (1 - a) over the block so far (cum) and the
// statistics prefixes (SA: D and D2; without SA: M1 and M2).
struct Run {
  float cum, p1, p2;
};

template <bool USE_SA>
GS_FN Run run_init(const PixState& s) {
  Run r;
  r.cum = 0.f;
  r.p1 = USE_SA ? s.D : s.M1;
  r.p2 = USE_SA ? s.D2 : s.M2;
  return r;
}

// One pair of a block's walk for one pixel: its geometry, accept decision
// and weight, with `run` advanced past it.
// composite_block and the backward's passes all step through here, so they
// agree bit for bit. A pair that fails the alpha test still takes its
// log1p(-0) = -0 and exp: computing them only where okf measured slower
// once the cull comes first (most pairs the cull keeps pass the test).
struct Step {
  Geom g;
  bool okf, below, af;
  float l, T_pref, w;
};

// T_in is the block's incoming transmittance (under BF16 rounded to
// bf16 by the caller, as the chain rounds it before its product).
template <bool USE_SA, class CT>
GS_FN Step pair_step(const float* sa, int j, int gi, int start, int stop,
                     float px, float py, float T_in, bool live, Run& run) {
  const auto r = [](float x) { return CT::r(x); };
  Step st;
  pair_geom<CT>(sa, j, px, py, st.g);
  st.okf = pair_ok(st.g, gi >= start && gi < stop, live);
  const float a_eff = st.okf ? st.g.a_cl : 0.f;
  st.l = r(log1pf(-a_eff));
  st.T_pref = r(T_in * r(expf(r(run.cum))));
  run.cum = run.cum + st.l;
  st.below = r(st.T_pref * r(1.f - a_eff)) < T_EPS;
  st.af = st.okf && !st.below;
  st.w = st.af ? r(st.g.a_cl * st.T_pref) : 0.f;
  if (USE_SA) {
    const float wd = r(st.w * st.g.d_raw);
    run.p1 = run.p1 + wd;
    run.p2 = run.p2 + r(wd * st.g.d_raw);
  } else if (st.af) {
    const float m = dist_m<CT>(st.g.d_raw);
    const float mw = r(m * st.w);
    run.p1 = run.p1 + mw;
    run.p2 = run.p2 + r(m * mw);
  }
  return st;
}

// A pixel's step mask over the block's 128 pairs: bit j is set where pair
// j touched the pixel (okf) or moved its prefixes (NaN included). A pair
// outside the mask leaves Run as it was and gets exactly zero gradient,
// so SA's second pass, the reverse walk and the re-run skip it. Four
// words, read through selects so that they stay in registers.
struct StepMask {
  unsigned w0, w1, w2, w3;
};

GS_FN bool mask_test(const StepMask& m, int j) {
  const unsigned w = j < 64 ? (j < 32 ? m.w0 : m.w1) : (j < 96 ? m.w2 : m.w3);
  return ((w >> (j & 31)) & 1u) != 0u;
}

GS_FN void mask_set(StepMask& m, int j) {
  const unsigned b = 1u << (j & 31);
  if (j < 32) m.w0 |= b;
  else if (j < 64) m.w1 |= b;
  else if (j < 96) m.w2 |= b;
  else m.w3 |= b;
}

GS_FN int ctz32(unsigned w) {
#if defined(__CUDACC__)
  return __ffs((int)w) - 1;
#else
  return __builtin_ctz(w);
#endif
}

// The first pair at or after j in the mask, CHUNK if none.
GS_FN int mask_next(const StepMask& m, int j) {
#pragma unroll 1
  for (; j < CHUNK; j = (j | 31) + 1) {
    const int wi = j >> 5;
    const unsigned w =
        (wi < 2 ? (wi == 0 ? m.w0 : m.w1) : (wi == 2 ? m.w2 : m.w3)) >>
        (j & 31);
    if (w != 0u) return j + ctz32(w);
  }
  return CHUNK;
}

// What one pixel's walk over a block sums over the pairs it accepts:
// their log-sum, the median and contributor indices, the colors, normals
// and depth statistics, and whether a pair triggered.
struct BlockAcc {
  float lsum, med_idx, mm_new, nc_blk;
  float racc, gacc, bacc, nxacc, nyacc, nzacc;
  float Dacc, D2acc, dist_add, m1_add, m2_add;
  bool trig;
};

GS_FN BlockAcc acc_init() {
  BlockAcc a;
  a.lsum = a.med_idx = a.mm_new = a.nc_blk = 0.f;
  a.racc = a.gacc = a.bacc = a.nxacc = a.nyacc = a.nzacc = 0.f;
  a.Dacc = a.D2acc = a.dist_add = a.m1_add = a.m2_add = 0.f;
  a.trig = false;
  return a;
}

// Pair j, the idx-th of the tile's range (1-based), accepted with weight
// w, raw depth d, log1p(-a) l and prefix transmittance T_pref; pre is the
// Run before it (the exclusive M1, M2 prefixes without SA).
template <bool USE_SA, bool NN, class CT>
GS_FN void accept_pair(BlockAcc& a, const float* sa, int j, int idx, float w,
                       float d, float l, float T_pref, const Run& pre) {
  const auto r = [](float x) { return CT::r(x); };
  a.lsum = a.lsum + l;
  const float gidx = (float)idx;
  if (T_pref > 0.5f) { a.med_idx = gidx; a.mm_new = d; }
  a.nc_blk = gidx;
  a.racc = a.racc + A<CT>(sa, 18, j) * w;
  a.gacc = a.gacc + A<CT>(sa, 19, j) * w;
  a.bacc = a.bacc + A<CT>(sa, 20, j) * w;
  if (NN) {
    a.nxacc = a.nxacc + A<CT>(sa, 14, j) * w;
    a.nyacc = a.nyacc + A<CT>(sa, 15, j) * w;
    a.nzacc = a.nzacc + A<CT>(sa, 16, j) * w;
  }
  if (!USE_SA) {
    const float m = dist_m<CT>(d);
    const float mw = r(m * w);
    a.dist_add = a.dist_add + (r(r(m * m) * r(1.f - T_pref)) + pre.p2 -
                               2.f * m * pre.p1) * w;
    a.m1_add = a.m1_add + mw;
    a.m2_add = a.m2_add + r(m * mw);
    a.Dacc = a.Dacc + r(d * w);
    a.D2acc = a.D2acc + r(r(d * d) * w);
  }
}

// SA's second pass: an accepted pair's fused depth into D and D2, with
// the block's median target mm_out.
template <class CT>
GS_FN void accept_fused(BlockAcc& a, float T_pref, const Run& pre,
                        float mm_out, float d, float w) {
  const float conf = sa_conf<CT>(T_pref, pre.p1, pre.p2, mm_out, d);
  const float df = conf * d + (1.f - conf) * mm_out;
  a.Dacc = a.Dacc + df * w;
  a.D2acc = a.D2acc + df * df * w;
}

// The median after the block: its last accepted pair with T_pref > 0.5,
// else the incoming one.
GS_FN float median_after(const BlockAcc& a, const PixState& s) {
  return a.med_idx > 0.f ? a.mm_new : s.mm;
}

// The pixel's state after the block from its incoming transmittance T_in.
template <bool USE_SA, bool NN>
GS_FN void finish_block(PixState& s, const BlockAcc& a, float T_in,
                        float mm_out) {
  s.T = T_in * expf(a.lsum);
  s.done = fmaxf(s.done, a.trig ? 1.f : 0.f);
  s.r = s.r + a.racc;
  s.g = s.g + a.gacc;
  s.b = s.b + a.bacc;
  s.nx = NN ? s.nx + a.nxacc : 0.f;
  s.ny = NN ? s.ny + a.nyacc : 0.f;
  s.nz = NN ? s.nz + a.nzacc : 0.f;
  s.D = s.D + a.Dacc;
  s.D2 = s.D2 + a.D2acc;
  if (!USE_SA) {
    s.M1 = s.M1 + a.m1_add;
    s.M2 = s.M2 + a.m2_add;
    s.dist = s.dist + a.dist_add;
  }
  s.mm = mm_out;
  s.nc = fmaxf(s.nc, a.nc_blk);
  s.mc = fmaxf(s.mc, a.med_idx);
}

// Composite one block for one pixel, updating `s` as composite_chunk does.
// Only the pairs of the tile's range [start, stop) are walked, each tested
// by its global index gstart + j, as the backward's first pass does:
// deriving block-local bounds once per block instead, ptxas (CUDA 12.9)
// built some instantiations and launch bounds wrong (every pair skipped),
// with and without spills. The first pass sums colors, normals and
// (without SA) the depth statistics of the accepted pairs and records the
// touched pairs in the step mask; with FWD_SKIP it skips, without
// changing a value:
//  * every pair of a pixel that is done at the block start (live false):
//    none is okf, so nothing is accepted, and the Run it would move is
//    read at accepted pairs only;
//  * a pair that pair_culled rejects: okf is false and Run stays as it
//    was (SA's prefixes would add 0 * d_raw, which is +0 for the finite
//    depth of a culled pair; a pair with NaN in it is never culled);
//  * every pair after the trigger (an okf pair whose inclusive product
//    T_pref * (1 - a) fell below T_EPS), under F32 only. cum has taken
//    the trigger's l, and cum only falls, so a later okf pair has T_pref
//    at most T_in * exp(cum) just past the trigger, which is the
//    trigger's T_pref * (1 - a) < T_EPS up to float rounding (a few ulp
//    of exp and log1p, about 1e-6 relative); its own (1 - a) <= 1 -
//    ALPHA_MIN takes 0.39% off that, far more than the rounding, so it is
//    below too: no later pair is accepted. Under BF16 the chain rounds
//    cum, exp, T_in, their product, 1 - a and the test's product, each by
//    up to 2^-9, more than that 0.39% together: a later pair can pass the
//    test (the card's phase-2 map showed it), so BF16 walks on.
// A warp whose lanes all skip a pair, or have all left the block, skips it
// as a whole (a uniform branch). SA's fusion weights need the block's
// final median, so a second pass re-runs pair_step over the step mask
// only: the pairs it skips leave run2 as it was and add nothing to Dacc /
// D2acc, so the sums come out as over the whole block, bit for bit.
template <bool USE_SA, bool NN, class CT>
GS_FN void composite_block(PixState& s, const float* sa, int gstart,
                           int start, int stop, float px, float py) {
  const float T_in = s.T;
  const float T_in_c = CT::r(T_in);
  const bool live = s.done < 0.5f;
  const int idx_base = gstart - start + 1;
  Run run = run_init<USE_SA>(s);
  BlockAcc acc = acc_init();
  StepMask mask = {0u, 0u, 0u, 0u};
#pragma unroll 1
  for (int j = 0; j < CHUNK; ++j) {
    const int gi = gstart + j;
    if (gi < start || gi >= stop) continue;
    if (FWD_SKIP && !(live && (CT::IS_BF16 || !acc.trig))) break;
    if (FWD_SKIP && pair_culled<CT>(sa, j, px, py)) continue;
    const Run pre = run;
    const Step st = pair_step<USE_SA, CT>(sa, j, gi, start, stop, px, py,
                                          T_in_c, live, run);
    acc.trig = acc.trig || (st.okf && st.below);
    if (st.okf || run.p1 != pre.p1 || run.p2 != pre.p2) mask_set(mask, j);
    if (!st.af) continue;
    accept_pair<USE_SA, NN, CT>(acc, sa, j, idx_base + j, st.w, st.g.d_raw,
                                st.l, st.T_pref, pre);
  }
  const float mm_out = median_after(acc, s);

  if (USE_SA) {
    Run run2 = run_init<true>(s);
#pragma unroll 1
    for (int j = FWD_SKIP ? mask_next(mask, 0) : 0; j < CHUNK;
         j = FWD_SKIP ? mask_next(mask, j + 1) : j + 1) {
      const int gi = gstart + j;
      if (gi < start || gi >= stop) continue;
      const Run pre = run2;
      const Step st = pair_step<true, CT>(sa, j, gi, start, stop, px, py,
                                          T_in_c, live, run2);
      if (st.af) accept_fused<CT>(acc, st.T_pref, pre, mm_out, st.g.d_raw,
                                  st.w);
    }
  }
  finish_block<USE_SA, NN>(s, acc, T_in, mm_out);
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
  float gTin;  // sum over visited pairs of dL/dT_pref * exp(cum)
};

// The reverse sweep sums a pair's gradient over the CTA's warps in rounds
// of BWD_GROUP pairs (one barrier pair a round).
constexpr int BWD_GROUP = 16;
constexpr int BWD_NGROUP = CHUNK / BWD_GROUP;

// A pixel's records: the Run before each pair in its step mask, in pair
// order, the n-th in slot n % REC_CAP of a ring of [3][REC_CAP][P] floats
// (column = pixel: a thread reads back only its own column, and a warp's
// accesses hit 32 banks). The first pass leaves the last REC_CAP of them
// in the ring; the reverse walk consumes them last first and re-runs the
// block from its start for the earlier ones (a pixel that more than
// REC_CAP pairs of one block touch). The CPU tests build the host math
// with a smaller ring (-DGS_REC_CAP) to drive that re-run.
#ifndef GS_REC_CAP
#define GS_REC_CAP 16
#endif
constexpr int REC_CAP = GS_REC_CAP;

GS_FN void put_rec(float* rec, int n, int p, const Run& r) {
  const int slot = n % REC_CAP;
  rec[(0 * REC_CAP + slot) * P + p] = r.cum;
  rec[(1 * REC_CAP + slot) * P + p] = r.p1;
  rec[(2 * REC_CAP + slot) * P + p] = r.p2;
}

GS_FN Run get_rec(const float* rec, int n, int p) {
  const int slot = n % REC_CAP;
  Run r;
  r.cum = rec[(0 * REC_CAP + slot) * P + p];
  r.p1 = rec[(1 * REC_CAP + slot) * P + p];
  r.p2 = rec[(2 * REC_CAP + slot) * P + p];
  return r;
}

// The backward's first pass over a block for pixel p: the block's walk
// without its sums (BlockInfo, as composite_block computes it), the step
// mask, the number of pairs in it (n_rec) and their records in the ring.
// A pair outside the tile's range, or culled for the pixel, is skipped:
// neither touches the pixel nor moves its Run. `sa` holds the cull radii
// (stage_block).
template <bool USE_SA, class CT>
GS_FN BlockInfo block_info(const PixState& s, const float* sa, int gstart,
                           int start, int stop, float px, float py, int p,
                           float* rec, StepMask& mask, int& n_rec) {
  const float T_in = s.T;
  const float T_in_c = CT::r(T_in);
  const bool live = s.done < 0.5f;
  const int idx_base = gstart - start + 1;
  Run run = run_init<USE_SA>(s);
  float lsum = 0.f, med_idx = 0.f, mm_new = 0.f;
  int med_j = -1, n = 0;
  mask.w0 = mask.w1 = mask.w2 = mask.w3 = 0u;
#pragma unroll 1
  for (int j = 0; j < CHUNK; ++j) {
    const int gi = gstart + j;
    if (gi < start || gi >= stop || pair_culled<CT>(sa, j, px, py)) continue;
    const Run pre = run;
    const Step st = pair_step<USE_SA, CT>(sa, j, gi, start, stop, px, py,
                                          T_in_c, live, run);
    if (st.okf || run.p1 != pre.p1 || run.p2 != pre.p2) {
      mask_set(mask, j);
      put_rec(rec, n++, p, pre);
    }
    if (!st.af) continue;
    lsum = lsum + st.l;
    if (st.T_pref > 0.5f) {
      med_idx = (float)(idx_base + j);
      mm_new = st.g.d_raw;
      med_j = j;
    }
  }
  n_rec = n;
  BlockInfo bi;
  bi.E = expf(lsum);
  bi.T_out = T_in * bi.E;
  bi.mm_out = med_idx > 0.f ? mm_new : s.mm;
  bi.med_j = med_idx > 0.f ? med_j : -1;
  return bi;
}

// The records n in [lo, hi) of pixel p back into the ring: the block
// re-run from its start (the stashed carry s) over the pairs of the step
// mask only. The pairs it skips leave Run as it was, so the records
// equal the first pass's values bit for bit (up to a zero's sign).
template <bool USE_SA, class CT>
GS_FN void refill_records(const PixState& s, const float* sa, int gstart,
                          int start, int stop, float px, float py, int p,
                          const StepMask& mask, int lo, int hi, float* rec) {
  const float T_in = CT::r(s.T);
  const bool live = s.done < 0.5f;
  Run run = run_init<USE_SA>(s);
  int n = 0;
#pragma unroll 1
  for (int j = 0; j < CHUNK && n < hi; ++j) {
    if (!mask_test(mask, j)) continue;
    if (n >= lo) put_rec(rec, n, p, run);
    pair_step<USE_SA, CT>(sa, j, gstart + j, start, stop, px, py, T_in, live,
                          run);
    ++n;
  }
}

// Hand-derived vjp of composite_block for pair j of one pixel, visited
// in reverse pair order. T_in / live are the block's incoming state, r
// the pair's record (the Run before it) and bi the block's forward
// recompute. Writes the pixel's contribution to the 21 attribute
// gradients into gv and returns whether the pair touched the pixel at all
// (okf); a pair that did not contributes exactly zero. The geometry and
// the accept decision repeat the forward's roundings; the vjp arithmetic
// itself rounds once per fused multiply-add (fmaf), which the library's
// -fmad=false leaves alone. Under BF16 the vjp is that same float32
// arithmetic on the forward's bf16-rounded values (the JAX package
// differentiates its bf16 chain, rounding each cotangent to bf16): the
// derivative of each rounding is taken as 1, and sx / sy clamped to
// +-S_MAX pass no gradient, as the JAX chain's clip.
// pair_vjp is the vjp of a pair that passed the alpha test (okf), from
// its geometry g, e = exp(cum), T_pref, the accept decision af and weight
// w; pair_grad (below) recomputes those and calls it.
template <bool USE_SA, bool NN, class CT>
GS_FN void pair_vjp(const float* sa, int j, const Geom& g, float px,
                    float py, float e, float T_pref, bool af, float w,
                    const BlockInfo& bi, const Cot& c, const Run& r,
                    RevCarry& rc, float* gv) {
  const auto rd = [](float x) { return CT::r(x); };
  float g_acl = 0.f, g_draw = 0.f, g_Tpref = 0.f;
  if (af) {
    // w = a_cl * T_pref feeds colors, normals, D, D2 (and M1, M2, dist)
    float g_w = fmaf(c.b, A<CT>(sa, 20, j),
                     fmaf(c.g, A<CT>(sa, 19, j), c.r * A<CT>(sa, 18, j)));
    if (NN)
      g_w = fmaf(c.nz, A<CT>(sa, 16, j),
                 fmaf(c.ny, A<CT>(sa, 15, j),
                      fmaf(c.nx, A<CT>(sa, 14, j), g_w)));
    if (USE_SA) {
      // d_fused = conf*d_raw + (1-conf)*mm_tgt, conf and mm_tgt detached
      const float conf =
          sa_conf<CT>(T_pref, r.p1, r.p2, bi.mm_out, g.d_raw);
      const float df = fmaf(conf, g.d_raw, (1.f - conf) * bi.mm_out);
      g_w = fmaf(c.D2, df * df, fmaf(c.D, df, g_w));
      g_draw = conf * (w * fmaf(2.f * c.D2, df, c.D));
    } else {
      const float d = g.d_raw;
      g_w = fmaf(c.D2, d * d, fmaf(c.D, d, g_w));
      g_draw = w * fmaf(2.f * c.D2, d, c.D);
      // dist = sum_i (m_i^2 A_i + M2p_i - 2 m_i M1p_i) w_i with the
      // exclusive prefixes M1p, M2p (the record) and A_i = 1 - T_pref_i
      const float m = dist_m<CT>(d);
      const float m2 = rd(m * m);
      const float Ap = rd(1.f - T_pref);
      const float own = fmaf(m2, Ap, fmaf(-2.f * m, r.p1, r.p2));
      const float later = fmaf(m2, rc.S_w, -2.f * m * rc.S_wm);
      g_w = fmaf(c.dist, own + later, fmaf(c.M2, m2, fmaf(c.M1, m, g_w)));
      const float g_m =
          w * fmaf(2.f * c.dist, fmaf(m, Ap + rc.S_w, -r.p1) - rc.S_wm,
                   fmaf(2.f * m, c.M2, c.M1));
      g_Tpref = -(c.dist * m2 * w);
      if (d > CT::D_MIN)
        g_draw = fmaf(g_m, (CT::M_SCALE * CT::NEAR) / (d * d), g_draw);
      rc.S_w += w;
      rc.S_wm = fmaf(w, m, rc.S_wm);
    }
    // the middepth output is the raw depth of the median pair (live)
    if (j == bi.med_j) g_draw += c.mm;
    g_Tpref = fmaf(g_w, g.a_cl, g_Tpref);
    g_acl = g_w * T_pref;
    gv[18] = w * c.r;
    gv[19] = w * c.g;
    gv[20] = w * c.b;
    if (NN) { gv[14] = w * c.nx; gv[15] = w * c.ny; gv[16] = w * c.nz; }
  }
  // l = log1p(-a_eff) feeds every later pair's T_pref and, if this pair
  // was accepted, T_out = T_in * exp(sum of accepted l)
  const float g_l = af ? fmaf(c.T, bi.T_out, rc.U) : rc.U;
  g_acl -= g_l / (1.f - g.a_cl);
  rc.U = fmaf(g_Tpref, T_pref, rc.U);
  rc.gTin = fmaf(g_Tpref, e, rc.gTin);

  // alpha_raw = op * exp(-rho / 2), rho = min(rho3d, rho2d); the clamp
  // to ALPHA_MAX passes its gradient through, ties split it evenly
  gv[17] = g_acl * g.gauss;
  const float g_rho = (g_acl * A<CT>(sa, 17, j)) * (g.gauss * -0.5f);
  float g3, g2;
  if (g.rho3d < g.rho2d) { g3 = g_rho; g2 = 0.f; }
  else if (g.rho2d < g.rho3d) { g3 = 0.f; g2 = g_rho; }
  else { g3 = 0.5f * g_rho; g2 = 0.5f * g_rho; }
  float g_sx = 2.f * g.sx * g3;
  float g_sy = 2.f * g.sy * g3;
  // d_raw = rho3d <= rho2d ? sx*twx + sy*twy + twz : twz
  if (g.use3d) {
    g_sx = fmaf(A<CT>(sa, 9, j), g_draw, g_sx);
    g_sy = fmaf(A<CT>(sa, 10, j), g_draw, g_sy);
    gv[9] = g.sx * g_draw;
    gv[10] = g.sy * g_draw;
  }
  if (CT::IS_BF16) {
    if (g.clx) g_sx = 0.f;
    if (g.cly) g_sy = 0.f;
  }
  gv[11] = g_draw;
  // rho2d = 100 * ((cx - px)^2 + (cy - py)^2)
  gv[12] = (FILTER_INV_SQUARE * 2.f) * g.dx * g2;
  gv[13] = (FILTER_INV_SQUARE * 2.f) * g.dy * g2;
  // (sx, sy) = (p_x, p_y) / p_z, p = px*a0 + py*a1 + a2
  const float g_px = g.inv_pz * g_sx;
  const float g_py = g.inv_pz * g_sy;
  const float g_inv = fmaf(g.p_x, g_sx, g.p_y * g_sy);
  const float g_pz = g.pz_ok ? -g_inv * (g.inv_pz * g.inv_pz) : 0.f;
  gv[0] = px * g_px; gv[1] = px * g_py; gv[2] = px * g_pz;
  gv[3] = py * g_px; gv[4] = py * g_py; gv[5] = py * g_pz;
  gv[6] = g_px; gv[7] = g_py; gv[8] = g_pz;
}


template <bool USE_SA, bool NN, class CT>
GS_FN bool pair_grad(const float* sa, int j, int gi, int start, int stop,
                     float px, float py, float T_in, bool live,
                     const BlockInfo& bi, const Cot& c, const Run& r,
                     RevCarry& rc, float* gv) {
  const auto rd = [](float x) { return CT::r(x); };
  for (int q = 0; q < GRAD_C; ++q) gv[q] = 0.f;
  Geom g;
  pair_geom<CT>(sa, j, px, py, g);
  if (!pair_ok(g, gi >= start && gi < stop, live)) return false;
  const float e = rd(expf(rd(r.cum)));
  const float T_pref = rd(rd(T_in) * e);
  const bool af = !(rd(T_pref * rd(1.f - g.a_cl)) < T_EPS);
  const float w = af ? rd(g.a_cl * T_pref) : 0.f;
  pair_vjp<USE_SA, NN, CT>(sa, j, g, px, py, e, T_pref, af, w, bi, c, r, rc,
                           gv);
  return true;
}

// Cotangent of the block's incoming state from the outgoing one: the
// carry for the previous block.
template <bool USE_SA, bool NN>
GS_FN void carry_cotangent(Cot& c, const BlockInfo& bi, const RevCarry& rc) {
  c.T = fmaf(c.T, bi.E, rc.gTin);
  if (!USE_SA) {
    c.M1 = fmaf(-2.f * c.dist, rc.S_wm, c.M1);
    c.M2 = fmaf(c.dist, rc.S_w, c.M2);
  }
  if (bi.med_j >= 0) c.mm = 0.f;
  if (!NN) { c.nx = 0.f; c.ny = 0.f; c.nz = 0.f; }
}

// The cotangent of a pixel's final state from the forward's output rows
// (`out`, stride apart; row 8 is the median) and the loss cotangent of
// those rows (`dout`): the closed-form vjp of compositing.finalize with
// background 0, as ops/raster_backward.py::finalize_cotangents forms it.
// With SA, dist = D2 - 2 mm D + mm^2 (1 - T) with mm detached; without,
// the accumulated distortion.
template <bool USE_SA>
GS_FN Cot cot_from_out(const float* out, const float* dout, int stride) {
  Cot c;
  const float mm = out[8 * stride];
  const float dD = dout[3 * stride], dA = dout[4 * stride];
  const float ddist = dout[9 * stride];
  c.r = dout[0 * stride]; c.g = dout[1 * stride]; c.b = dout[2 * stride];
  c.nx = dout[5 * stride]; c.ny = dout[6 * stride]; c.nz = dout[7 * stride];
  c.mm = dout[8 * stride];
  c.M1 = 0.f;
  c.M2 = 0.f;
  if (USE_SA) {
    c.D = dD - 2.f * mm * ddist;
    c.D2 = ddist;
    c.dist = 0.f;
    c.T = -dA - mm * mm * ddist;
  } else {
    c.D = dD;
    c.D2 = 0.f;
    c.dist = ddist;
    c.T = -dA;
  }
  return c;
}

// Warp reduce-scatter of a pair's gradient rows, padded to RS_SLOTS, by
// recursive halving: at the step of width h (16, 8, 4, 2, 1) a lane holds
// slots [0, 2h), keeps the half its lane bit h selects (rs_keep) and
// sends the other half (rs_send) to lane ^ h, which adds it to its own
// kept half in slot i. After the five steps (31 exchanges) lane l holds
// the warp's sum of row l. The kernel and csrc/pixel_math_host.cpp's 32
// simulated lanes both take the halves through these two helpers.
constexpr int RS_SLOTS = 32;

GS_FN float rs_keep(const float* v, int lane, int h, int i) {
  return (lane & h) ? v[i + h] : v[i];
}

GS_FN float rs_send(const float* v, int lane, int h, int i) {
  return (lane & h) ? v[i] : v[i + h];
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
// Stage block b of the [ATTR_C, R] slab into shared memory as sa[c][j]
// (CT::stage of each attribute), with each pair's cull radius in row
// RHO_ROW (padding in the slab).
template <class CT>
__device__ __forceinline__ void stage_block(float* sa, const float* attrs,
                                            int64_t R, int64_t gstart) {
  for (int e = threadIdx.x; e < ATTR_C * CHUNK; e += blockDim.x) {
    const int c = e / CHUNK, j = e % CHUNK;
    sa[e] = c == RHO_ROW ? rho_cull<CT>(attrs[17 * R + gstart + j])
                         : CT::stage(attrs[c * R + gstart + j]);
  }
}

// Shared memory of the forward walk, in floats: two staged blocks.
constexpr int FWD_SA = 2 * ATTR_C * CHUNK;

// Start copying block `gstart` of the [ATTR_C, R] slab into `sa` as
// sa[c][j] with cp.async (16 bytes a copy, straight to shared memory, one
// commit group per block); the pad row RHO_ROW is left to the caller. The
// slab's rows must be 16-byte aligned (the wrappers see to it).
__device__ __forceinline__ void stage_async(float* sa, const float* attrs,
                                            int64_t R, int64_t gstart) {
  constexpr int Q = CHUNK / 4;  // 16-byte pieces of a row
  for (int e = threadIdx.x; e < ATTR_C * Q; e += blockDim.x) {
    const int c = e / Q, q = e % Q;
    if (c == RHO_ROW) continue;
    const unsigned dst =
        (unsigned)__cvta_generic_to_shared(sa + c * CHUNK + 4 * q);
    const size_t src = __cvta_generic_to_global(attrs + c * R + gstart + 4 * q);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One CTA's forward walk over the first `nblk` blocks of its tile, from
// the pixel state `s` (K1, K3, and K5's re-forward; F32, the packed BF16
// walk is raster_bf16x2.cuh's forward_walk2): each block staged
// once, with its pairs' cull radii, every pixel compositing it; the walk
// stops once every pixel of the tile has terminated. `sa` holds FWD_SA
// floats, two buffers: block k + 1 is copied into one (stage_async) while
// block k is composited from the other; threads 0..CHUNK-1 load block
// k + 1's opacities into a register as its copy starts and write its cull
// radii (the pad row RHO_ROW) once block k is composited. With STASH,
// each block's incoming carry goes to stash row soff + k (rows past
// stash_rows are skipped). Returns the number of blocks composited.
template <bool STASH, bool USE_SA, bool NN>
__device__ __forceinline__ int forward_walk(
    PixState& s, float* sa, const float* __restrict__ attrs, int R,
    const TileWalk& tw, int nblk, float px, float py, float* stash,
    int soff, int stash_rows) {
  const int p = threadIdx.x;
  const int64_t g0 = (int64_t)tw.blk0 * CHUNK;
  if (nblk > 0) {
    stage_async(sa, attrs, R, g0);
    if (p < CHUNK)
      sa[RHO_ROW * CHUNK + p] = rho_cull<F32>(attrs[17 * R + g0 + p]);
  }
  int k = 0;
  for (; k < nblk; ++k) {
    // exit once every pixel of the tile has terminated (this barrier also
    // orders the reads of block k - 1 before its buffer takes block k + 1)
    if (__syncthreads_and(s.done >= 0.5f)) break;
    const int64_t gstart = g0 + (int64_t)k * CHUNK;
    float* cur = sa + (k & 1) * (ATTR_C * CHUNK);
    float* nxt = sa + ((k + 1) & 1) * (ATTR_C * CHUNK);
    const bool more = k + 1 < nblk;
    float op_next = 0.f;
    if (more) {
      stage_async(nxt, attrs, R, gstart + CHUNK);
      if (p < CHUNK) op_next = attrs[17 * R + gstart + CHUNK + p];
    }
    if (STASH && soff + k < stash_rows)
      store_stash(stash + ((int64_t)(soff + k) * STASH_C) * P + p, P, s);
    // block k's copies landed (this thread's), then everyone's
    if (more) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    composite_block<USE_SA, NN, F32>(s, cur, (int)gstart, tw.start, tw.stop,
                                    px, py);
    if (more && p < CHUNK) nxt[RHO_ROW * CHUNK + p] = rho_cull<F32>(op_next);
  }
  // a walk that stopped early leaves block k + 1's copies in flight
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  return k;
}

// One halving step of width H (a template, so every slot index is a
// constant and v stays in registers). Slots i and i + H are read before
// slot i is written; later i read only slots above i.
template <int H>
__device__ __forceinline__ void rs_step(float* v, int lane) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = rs_send(v, lane, H, i);
    v[i] = rs_keep(v, lane, H, i) + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// The warp's sums of gv[q] over its 32 lanes, reduce-scattered: lane q
// returns the sum of row q (q < GRAD_C; the other lanes return 0).
__device__ __forceinline__ float warp_reduce_scatter(const float* gv,
                                                     int lane) {
  static_assert(RS_SLOTS == 32 && GRAD_C <= RS_SLOTS, "one slot per lane");
  float v[RS_SLOTS];
#pragma unroll
  for (int q = 0; q < RS_SLOTS; ++q) v[q] = q < GRAD_C ? gv[q] : 0.f;
  rs_step<16>(v, lane);
  rs_step<8>(v, lane);
  rs_step<4>(v, lane);
  rs_step<2>(v, lane);
  rs_step<1>(v, lane);
  return v[0];
}
#endif

}  // namespace gs
