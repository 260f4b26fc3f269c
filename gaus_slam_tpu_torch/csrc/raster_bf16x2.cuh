// The BF16 compute type of K1, K3 and K2 (tpu.compute_dtype "bf16")
// packed for Hopper's bf16x2 arithmetic: raster_common.cuh's BF16 chain,
// two pixels a thread.
//
// K1-bf16 / K3-bf16 run a tile on P2 = 128 threads, and so does K2-bf16's
// first pass over each block: thread t owns the horizontally
// neighbouring pixels 2t (lane 0) and 2t + 1 (lane 1) of the tile, which
// mostly accept the same pairs. (K2-bf16's reverse walk, whose vjp stays
// float32, runs one pixel a thread on lane 0 of the same packed chain:
// pair_grad1.) Every rounded op of the chain is one
// packed op for both (add.rn / sub.rn / mul.rn.bf16x2, never a fused
// multiply-add): the ray-splat geometry, the 2D distance, rho, the alpha
// clamp, the transmittance product, the accept test's product, the weight
// and SA's prefix products. An add, sub or mul of two bf16 values rounded
// once to bf16 equals the float32 op rounded to bf16 (24 >= 2 * 8 + 2, so
// the double rounding is innocuous), and every operand of the chain is a
// bf16 value (the rounded pixel coordinates, the rounded attributes and
// each earlier result): the packed chain gives the one-pixel BF16 walk's
// bits (tests/test_torch_bf16_packed.py holds both, and the premise, on
// the CPU). The division, expf and log1pf stay float32 per lane and are
// rounded two at a time (cvt.rn.bf16x2.f32). The per-pixel state, the
// sums, SA's fusion weight and K2's vjp stay float32 per lane, as the
// one-pixel walk has them (accept_pair, accept_fused, pair_vjp with the
// compute type BF16P). A decision that differs between the lanes (the
// cull, okf, the accept test, the step mask) is a select or a per-lane
// flag, never a branch of the thread; a thread skips a pair only when
// both lanes do, a warp only when its 64 pixels do.
//
// The block is rounded once, as it is staged (BF16P::stage): on the card
// each attribute word of shared memory holds its bf16 value in both
// halves of a bf16x2 word, so one 32-bit load gives the packed operand and
// the float32 reader (BF16P::attr) masks the high half. The cull radius
// row (RHO_ROW) stays float32.
//
// One geometry per (pair, pixel): the first pass computes the rounded
// rho2d, then the ray's coordinates, then rho3d (the cull compares both
// with the radius, as pair_culled<BF16> does, bit for bit; a test on the
// coordinates that implies it spares the division where both lanes pass
// it), then the rest of the geometry only for a pair some lane keeps, and
// pair_step2 reuses it.
//
// The same code compiles as plain C++ for csrc/pixel_math_host.cpp, where
// bf2 is a two-lane struct whose ops are the float32 op and bf16_round per
// lane: the same bits by the argument above.
#pragma once
#include "raster_common.cuh"

namespace gs {

// Threads of a packed CTA: one for each two pixels of the tile.
constexpr int P2 = P / 2;
static_assert(P2 == CHUNK, "a packed CTA loads one pair per thread");

#if defined(__CUDACC__)
using bf2 = __nv_bfloat162;

GS_FN bf2 add2(bf2 a, bf2 b) { return __hadd2_rn(a, b); }
GS_FN bf2 sub2(bf2 a, bf2 b) { return __hsub2_rn(a, b); }
GS_FN bf2 mul2(bf2 a, bf2 b) { return __hmul2_rn(a, b); }
// fminf / fmaxf per lane: a NaN operand gives the other one
GS_FN bf2 min2(bf2 a, bf2 b) { return __hmin2(a, b); }
GS_FN bf2 max2(bf2 a, bf2 b) { return __hmax2(a, b); }
GS_FN bf2 pack2(float a, float b) { return __floats2bfloat162_rn(a, b); }
GS_FN bf2 splat2(float x) { return __float2bfloat162_rn(x); }
GS_FN float lane(bf2 v, int q) {
  return q ? __high2float(v) : __low2float(v);
}
GS_FN unsigned bits2(bf2 v) {
  unsigned u;
  memcpy(&u, &v, sizeof u);
  return u;
}
GS_FN bf2 from_bits2(unsigned u) {
  bf2 v;
  memcpy(&v, &u, sizeof u);
  return v;
}
// lane q of a where cq, else of b
GS_FN bf2 sel2(bool c0, bool c1, bf2 a, bf2 b) {
  const unsigned m = (c0 ? 0x0000ffffu : 0u) | (c1 ? 0xffff0000u : 0u);
  return from_bits2((bits2(a) & m) | (bits2(b) & ~m));
}
// x clamped to +-S_MAX per lane; a NaN stays a NaN (its payload may not)
GS_FN bf2 clamp2(bf2 x) {
  const bf2 s = splat2(BF16::S_MAX);
  return __hmin2_nan(__hmax2_nan(x, __hneg2(s)), s);
}
#else
struct bf2 {
  float v[2];
};

GS_FN bf2 add2(bf2 a, bf2 b) {
  return {{bf16_round(a.v[0] + b.v[0]), bf16_round(a.v[1] + b.v[1])}};
}
GS_FN bf2 sub2(bf2 a, bf2 b) {
  return {{bf16_round(a.v[0] - b.v[0]), bf16_round(a.v[1] - b.v[1])}};
}
GS_FN bf2 mul2(bf2 a, bf2 b) {
  return {{bf16_round(a.v[0] * b.v[0]), bf16_round(a.v[1] * b.v[1])}};
}
GS_FN bf2 min2(bf2 a, bf2 b) {
  return {{fminf(a.v[0], b.v[0]), fminf(a.v[1], b.v[1])}};
}
GS_FN bf2 max2(bf2 a, bf2 b) {
  return {{fmaxf(a.v[0], b.v[0]), fmaxf(a.v[1], b.v[1])}};
}
GS_FN bf2 pack2(float a, float b) { return {{bf16_round(a), bf16_round(b)}}; }
GS_FN bf2 splat2(float x) { return pack2(x, x); }
GS_FN float lane(bf2 v, int q) { return v.v[q]; }
GS_FN bf2 sel2(bool c0, bool c1, bf2 a, bf2 b) {
  return {{c0 ? a.v[0] : b.v[0], c1 ? a.v[1] : b.v[1]}};
}
GS_FN float clamp1(float x) {
  return fabsf(x) > BF16::S_MAX ? copysignf(BF16::S_MAX, x) : x;
}
GS_FN bf2 clamp2(bf2 x) { return {{clamp1(x.v[0]), clamp1(x.v[1])}}; }
#endif

// A float's bits and back, for the words the passes hand on.
GS_FN unsigned fbits(float x) {
  unsigned u;
  memcpy(&u, &x, sizeof u);
  return u;
}

GS_FN float bitsf(unsigned u) {
  float x;
  memcpy(&x, &u, sizeof x);
  return x;
}

// The staged word of attribute x and its readers: on the card the bf16
// value in both halves of a bf16x2 word, on the host the rounded float.
GS_FN float stage_word(float x) {
#if defined(__CUDACC__)
  return __uint_as_float(bits2(splat2(x)));
#else
  return bf16_round(x);
#endif
}

GS_FN bf2 attr2(const float* sa, int c, int j) {
#if defined(__CUDACC__)
  return from_bits2(__float_as_uint(sa[c * CHUNK + j]));
#else
  const float x = sa[c * CHUNK + j];
  return {{x, x}};
#endif
}

// BF16 on a block staged by stage_word: the float32 parts of the walk
// (accept_pair, accept_fused, pair_vjp) read the staged words through it.
struct BF16P : BF16 {
  static GS_FN float stage(float x) { return stage_word(x); }
  static GS_FN float attr(const float* sa, int i) {
#if defined(__CUDACC__)
    return __uint_as_float(__float_as_uint(sa[i]) & 0xffff0000u);
#else
    return sa[i];
#endif
  }
};

// pair_geom for both lanes, in four parts: the 2D distance (the cull's
// first test), the ray's coordinates, the division through rho3d (the
// cull's second test), and the depth and alpha. Flags are per lane.
struct Geom2 {
  bf2 p_x, p_y, p_z, inv_pz, sx, sy, rho3d, rho2d, dx, dy, d_raw, gauss;
  bf2 alpha_raw, a_cl;
  bool pz_ok[2], use3d[2], clx[2], cly[2];
};

GS_FN void geom2_2d(const float* sa, int j, bf2 px, bf2 py, Geom2& g) {
  g.dx = sub2(attr2(sa, 12, j), px);
  g.dy = sub2(attr2(sa, 13, j), py);
  g.rho2d = mul2(splat2(FILTER_INV_SQUARE),
                 add2(mul2(g.dx, g.dx), mul2(g.dy, g.dy)));
}

GS_FN void geom2_ray(const float* sa, int j, bf2 px, bf2 py, Geom2& g) {
  g.p_x = add2(add2(mul2(px, attr2(sa, 0, j)), mul2(py, attr2(sa, 3, j))),
               attr2(sa, 6, j));
  g.p_y = add2(add2(mul2(px, attr2(sa, 1, j)), mul2(py, attr2(sa, 4, j))),
               attr2(sa, 7, j));
  g.p_z = add2(add2(mul2(px, attr2(sa, 2, j)), mul2(py, attr2(sa, 5, j))),
               attr2(sa, 8, j));
}

GS_FN void geom2_3d(Geom2& g) {
  float inv[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    // (pz_ok ? 1 : 0) / (pz_ok ? p_z : 1), as pair_geom divides
    const float z = lane(g.p_z, q);
    g.pz_ok[q] = z != 0.f;
    inv[q] = g.pz_ok[q] ? 1.f / z : 0.f;
  }
  g.inv_pz = pack2(inv[0], inv[1]);
  const bf2 sx = mul2(g.p_x, g.inv_pz);
  const bf2 sy = mul2(g.p_y, g.inv_pz);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    g.clx[q] = fabsf(lane(sx, q)) > BF16::S_MAX;
    g.cly[q] = fabsf(lane(sy, q)) > BF16::S_MAX;
  }
  g.sx = clamp2(sx);
  g.sy = clamp2(sy);
  g.rho3d = add2(mul2(g.sx, g.sx), mul2(g.sy, g.sy));
}

GS_FN void geom2_alpha(const float* sa, int j, Geom2& g) {
  const bf2 twz = attr2(sa, 11, j);
  const bf2 d3 = add2(add2(mul2(g.sx, attr2(sa, 9, j)),
                           mul2(g.sy, attr2(sa, 10, j))), twz);
#pragma unroll
  for (int q = 0; q < 2; ++q)
    g.use3d[q] = lane(g.rho3d, q) <= lane(g.rho2d, q);
  g.d_raw = sel2(g.use3d[0], g.use3d[1], d3, twz);
  const bf2 rho = min2(g.rho3d, g.rho2d);
  g.gauss = pack2(expf(-0.5f * lane(rho, 0)), expf(-0.5f * lane(rho, 1)));
  g.alpha_raw = mul2(attr2(sa, 17, j), g.gauss);
  g.a_cl = sub2(g.alpha_raw, max2(sub2(g.alpha_raw, splat2(BF16::ALPHA_MAX)),
                                  splat2(0.f)));
}

GS_FN void geom2(const float* sa, int j, bf2 px, bf2 py, Geom2& g) {
  geom2_2d(sa, j, px, py, g);
  geom2_ray(sa, j, px, py, g);
  geom2_3d(g);
  geom2_alpha(sa, j, g);
}

// Lane q of the geometry, as pair_geom<BF16> computes it for that pixel.
GS_FN Geom lane_geom(const Geom2& g2, int q) {
  Geom g;
  g.p_x = lane(g2.p_x, q); g.p_y = lane(g2.p_y, q); g.p_z = lane(g2.p_z, q);
  g.inv_pz = lane(g2.inv_pz, q);
  g.sx = lane(g2.sx, q); g.sy = lane(g2.sy, q);
  g.rho3d = lane(g2.rho3d, q); g.rho2d = lane(g2.rho2d, q);
  g.dx = lane(g2.dx, q); g.dy = lane(g2.dy, q);
  g.d_raw = lane(g2.d_raw, q); g.gauss = lane(g2.gauss, q);
  g.alpha_raw = lane(g2.alpha_raw, q); g.a_cl = lane(g2.a_cl, q);
  g.pz_ok = g2.pz_ok[q]; g.use3d = g2.use3d[q];
  g.clx = g2.clx[q]; g.cly = g2.cly[q];
  return g;
}

// pair_ok for lane q
GS_FN bool lane_ok(const Geom2& g, int q, bool valid, bool live) {
  return live && valid && g.pz_ok[q] && lane(g.d_raw, q) >= NEAR_N &&
         lane(g.alpha_raw, q) >= ALPHA_MIN;
}

// Whether lane q's pixel surely fails the pair's alpha test: pair_culled
// <BF16>'s test on the geometry's own rounded rho2d and rho3d.
GS_FN bool lane_culled(const Geom2& g, int q, float lim) {
  return lane(g.rho2d, q) > lim && lane(g.rho3d, q) > lim;
}

// A sufficient condition for lane q's rounded rho3d > lim from the ray's
// coordinates alone, without the division: X = p_x^2 + p_y^2 > lim (1 +
// 2^-5) Z, Z = p_z^2, with X finite and Z >= 2^-100. The squares of the
// bf16 coordinates are exact in float32 and X, and the product with Z,
// round once (2^-24 each). Then 1 / p_z is a normal float (|p_z| in
// [2^-50, 2^64)); the chain rounds it, sx and sy, their squares and the
// sum, six roundings of at most 2^-9 relative each (a square's
// underflow adds at most 2^-133 to a sum past 1/64, as X / Z > lim (1 +
// 2^-5) >= 1/32 whenever lim > 0), so rho3d >= X / Z (1 - 0.0123) > lim;
// a clamp to S_MAX only raises rho3d (to ~1e8, past every radius), and
// nothing in it is NaN. With lim = -1 (no pixel can accept the pair)
// rho3d >= 0 > lim all the same. A NaN or inf fails the test. So a lane
// that passes it is culled by lane_culled too (once rho2d > lim): the
// walks test it first and compute the division only for a pair that
// some lane may keep, with the same decisions.
GS_FN bool lane_far_ray(const Geom2& g, int q, float lim) {
  const float x = lane(g.p_x, q), y = lane(g.p_y, q), z = lane(g.p_z, q);
  const float X = x * x + y * y, Z = z * z;
  return X < INFINITY && Z >= 0x1p-100f && X > (lim * 1.03125f) * Z;
}

struct Step2 {
  bf2 l, T_pref, w;
  bool okf[2], below[2], af[2];
};

// pair_step for the lanes that act on the pair, from its geometry g: a
// lane that does not act keeps its Run, and nothing reads its values.
template <bool USE_SA>
GS_FN void pair_step2(const Geom2& g, const bool act[2], bool valid,
                      const bool live[2], bf2 T_in, Run run[2], Step2& st) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
    st.okf[q] = act[q] && lane_ok(g, q, valid, live[q]);
  const bf2 zero = splat2(0.f);
  const bf2 a_eff = sel2(st.okf[0], st.okf[1], g.a_cl, zero);
  st.l = pack2(log1pf(-lane(a_eff, 0)), log1pf(-lane(a_eff, 1)));
  const bf2 cum = pack2(run[0].cum, run[1].cum);
  st.T_pref = mul2(T_in, pack2(expf(lane(cum, 0)), expf(lane(cum, 1))));
  const bf2 keep = mul2(st.T_pref, sub2(splat2(1.f), a_eff));
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (act[q]) run[q].cum = run[q].cum + lane(st.l, q);
    st.below[q] = lane(keep, q) < T_EPS;
    st.af[q] = st.okf[q] && !st.below[q];
  }
  st.w = sel2(st.af[0], st.af[1], mul2(g.a_cl, st.T_pref), zero);
  if (USE_SA) {
    const bf2 wd = mul2(st.w, g.d_raw);
    const bf2 wdd = mul2(wd, g.d_raw);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!act[q]) continue;
      run[q].p1 = run[q].p1 + lane(wd, q);
      run[q].p2 = run[q].p2 + lane(wdd, q);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!(act[q] && st.af[q])) continue;
      const float m = dist_m<BF16>(lane(g.d_raw, q));
      const float mw = BF16::r(m * lane(st.w, q));
      run[q].p1 = run[q].p1 + mw;
      run[q].p2 = run[q].p2 + BF16::r(m * mw);
    }
  }
}

GS_FN StepMask mask_union(const StepMask& a, const StepMask& b) {
  return {a.w0 | b.w0, a.w1 | b.w1, a.w2 | b.w2, a.w3 | b.w3};
}

// composite_block<USE_SA, NN, BF16> for the two pixels of a thread (s[0]
// at px lane 0, s[1] at lane 1), with the same skips (FWD_SKIP) per lane:
// a lane whose pixel is done at the block start, or that the cull
// rejects, does not act on the pair; the thread leaves the block once
// both pixels are done. SA's second pass walks the union of the two step
// masks, each lane acting on its own.
template <bool USE_SA, bool NN>
GS_FN void composite_block2(PixState s[2], const float* sa, int gstart,
                            int start, int stop, bf2 px, bf2 py) {
  float T_in[2];
  bool live[2];
  Run run[2];
  BlockAcc acc[2];
  StepMask mask[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    T_in[q] = s[q].T;
    live[q] = s[q].done < 0.5f;
    run[q] = run_init<USE_SA>(s[q]);
    acc[q] = acc_init();
    mask[q] = {0u, 0u, 0u, 0u};
  }
  const bf2 T_in_c = pack2(T_in[0], T_in[1]);
  const int idx_base = gstart - start + 1;
#pragma unroll 1
  for (int j = 0; j < CHUNK; ++j) {
    const int gi = gstart + j;
    if (gi < start || gi >= stop) continue;
    if (FWD_SKIP && !(live[0] || live[1])) break;
    Geom2 g;
    geom2_2d(sa, j, px, py, g);
    geom2_ray(sa, j, px, py, g);
    bool act[2] = {!FWD_SKIP || live[0], !FWD_SKIP || live[1]};
    if (FWD_SKIP) {
      const float lim = sa[RHO_ROW * CHUNK + j];
#pragma unroll
      for (int q = 0; q < 2; ++q)
        act[q] = act[q] &&
                 !(lane(g.rho2d, q) > lim && lane_far_ray(g, q, lim));
      if (!(act[0] || act[1])) continue;
      geom2_3d(g);
#pragma unroll
      for (int q = 0; q < 2; ++q) act[q] = act[q] && !lane_culled(g, q, lim);
      if (!(act[0] || act[1])) continue;
    } else {
      geom2_3d(g);
    }
    geom2_alpha(sa, j, g);
    const Run pre[2] = {run[0], run[1]};
    Step2 st;
    pair_step2<USE_SA>(g, act, true, live, T_in_c, run, st);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!act[q]) continue;
      acc[q].trig = acc[q].trig || (st.okf[q] && st.below[q]);
      if (st.okf[q] || run[q].p1 != pre[q].p1 || run[q].p2 != pre[q].p2)
        mask_set(mask[q], j);
      if (st.af[q])
        accept_pair<USE_SA, NN, BF16P>(acc[q], sa, j, idx_base + j,
                                       lane(st.w, q), lane(g.d_raw, q),
                                       lane(st.l, q), lane(st.T_pref, q),
                                       pre[q]);
    }
  }
  float mm_out[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) mm_out[q] = median_after(acc[q], s[q]);

  if (USE_SA) {
    Run run2[2] = {run_init<true>(s[0]), run_init<true>(s[1])};
    const StepMask both = mask_union(mask[0], mask[1]);
#pragma unroll 1
    for (int j = FWD_SKIP ? mask_next(both, 0) : 0; j < CHUNK;
         j = FWD_SKIP ? mask_next(both, j + 1) : j + 1) {
      const int gi = gstart + j;
      if (gi < start || gi >= stop) continue;
      const bool act[2] = {!FWD_SKIP || mask_test(mask[0], j),
                           !FWD_SKIP || mask_test(mask[1], j)};
      Geom2 g;
      geom2(sa, j, px, py, g);
      const Run pre[2] = {run2[0], run2[1]};
      Step2 st;
      pair_step2<true>(g, act, true, live, T_in_c, run2, st);
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (st.af[q])
          accept_fused<BF16P>(acc[q], lane(st.T_pref, q), pre[q], mm_out[q],
                              lane(g.d_raw, q), lane(st.w, q));
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
    finish_block<USE_SA, NN>(s[q], acc[q], T_in[q], mm_out[q]);
}

// block_info<USE_SA, BF16> for the two pixels of a thread; lane q's
// records go to ring column col[q].
template <bool USE_SA>
GS_FN void block_info2(const PixState s[2], const float* sa, int gstart,
                       int start, int stop, bf2 px, bf2 py, const int col[2],
                       float* rec, StepMask mask[2], int n_rec[2],
                       BlockInfo bi[2]) {
  const bf2 T_in_c = pack2(s[0].T, s[1].T);
  const bool live[2] = {s[0].done < 0.5f, s[1].done < 0.5f};
  const int idx_base = gstart - start + 1;
  Run run[2] = {run_init<USE_SA>(s[0]), run_init<USE_SA>(s[1])};
  float lsum[2] = {0.f, 0.f}, med_idx[2] = {0.f, 0.f}, mm_new[2] = {0.f, 0.f};
  int med_j[2] = {-1, -1}, n[2] = {0, 0};
#pragma unroll
  for (int q = 0; q < 2; ++q) mask[q] = {0u, 0u, 0u, 0u};
#pragma unroll 1
  for (int j = 0; j < CHUNK; ++j) {
    const int gi = gstart + j;
    if (gi < start || gi >= stop) continue;
    Geom2 g;
    geom2_2d(sa, j, px, py, g);
    geom2_ray(sa, j, px, py, g);
    const float lim = sa[RHO_ROW * CHUNK + j];
    if ((lane(g.rho2d, 0) > lim && lane_far_ray(g, 0, lim)) &&
        (lane(g.rho2d, 1) > lim && lane_far_ray(g, 1, lim)))
      continue;
    geom2_3d(g);
    const bool act[2] = {!lane_culled(g, 0, lim), !lane_culled(g, 1, lim)};
    if (!(act[0] || act[1])) continue;
    geom2_alpha(sa, j, g);
    const Run pre[2] = {run[0], run[1]};
    Step2 st;
    pair_step2<USE_SA>(g, act, true, live, T_in_c, run, st);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!act[q]) continue;
      if (st.okf[q] || run[q].p1 != pre[q].p1 || run[q].p2 != pre[q].p2) {
        mask_set(mask[q], j);
        put_rec(rec, n[q]++, col[q], pre[q]);
      }
      if (!st.af[q]) continue;
      lsum[q] = lsum[q] + lane(st.l, q);
      if (lane(st.T_pref, q) > 0.5f) {
        med_idx[q] = (float)(idx_base + j);
        mm_new[q] = lane(g.d_raw, q);
        med_j[q] = j;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    n_rec[q] = n[q];
    bi[q].E = expf(lsum[q]);
    bi[q].T_out = s[q].T * bi[q].E;
    bi[q].mm_out = med_idx[q] > 0.f ? mm_new[q] : s[q].mm;
    bi[q].med_j = med_idx[q] > 0.f ? med_j[q] : -1;
  }
}

// refill_records<USE_SA, BF16> for lane q alone (its records n in
// [lo, hi), column col, step mask mask), on the packed chain.
template <bool USE_SA>
GS_FN void refill_records2(int q, const PixState s[2], const float* sa,
                           int gstart, int start, int stop, bf2 px, bf2 py,
                           int col, const StepMask& mask, int lo, int hi,
                           float* rec) {
  const bf2 T_in_c = pack2(s[0].T, s[1].T);
  const bool live[2] = {s[0].done < 0.5f, s[1].done < 0.5f};
  const bool act[2] = {q == 0, q == 1};
  Run run[2] = {run_init<USE_SA>(s[0]), run_init<USE_SA>(s[1])};
  int n = 0;
#pragma unroll 1
  for (int j = 0; j < CHUNK && n < hi; ++j) {
    if (!mask_test(mask, j)) continue;
    if (n >= lo) put_rec(rec, n, col, run[q]);
    const int gi = gstart + j;
    Geom2 g;
    geom2(sa, j, px, py, g);
    Step2 st;
    pair_step2<USE_SA>(g, act, gi >= start && gi < stop, live, T_in_c, run,
                       st);
    ++n;
  }
}

// pair_grad<USE_SA, NN, BF16> for the two lanes of a thread, in two
// steps: pair_prep2 recomputes the pair's geometry and its accept test
// once, packed, for the lanes `in` (the pair in the lane's step mask;
// r[q]: lane q's record), and lane_grad runs lane q's float32 vjp from it
// into gv (zero where the lane is not in the mask or the pair not okf).
struct Prep2 {
  Geom2 g;
  bf2 e, T_pref, keep, w;
  bool ok[2];
};

template <bool USE_SA>
GS_FN void pair_prep2(const float* sa, int j, int gi, int start, int stop,
                      bf2 px, bf2 py, bf2 T_in, const bool live[2],
                      const bool in[2], const Run r[2], Prep2& pr) {
  geom2(sa, j, px, py, pr.g);
  const bool valid = gi >= start && gi < stop;
#pragma unroll
  for (int q = 0; q < 2; ++q)
    pr.ok[q] = in[q] && lane_ok(pr.g, q, valid, live[q]);
  if (!(pr.ok[0] || pr.ok[1])) return;
  const bf2 cum = pack2(r[0].cum, r[1].cum);
  pr.e = pack2(expf(lane(cum, 0)), expf(lane(cum, 1)));
  pr.T_pref = mul2(T_in, pr.e);
  pr.keep = mul2(pr.T_pref, sub2(splat2(1.f), pr.g.a_cl));
  pr.w = mul2(pr.g.a_cl, pr.T_pref);
}

template <bool USE_SA, bool NN>
GS_FN void lane_grad(const float* sa, int j, const Prep2& pr, int q,
                     float pxf, float pyf, const BlockInfo& bi, const Cot& c,
                     const Run& r, RevCarry& rc, float* gv) {
#pragma unroll
  for (int k = 0; k < GRAD_C; ++k) gv[k] = 0.f;
  if (!pr.ok[q]) return;
  const bool af = !(lane(pr.keep, q) < T_EPS);
  pair_vjp<USE_SA, NN, BF16P>(sa, j, lane_geom(pr.g, q), pxf, pyf,
                              lane(pr.e, q), lane(pr.T_pref, q), af,
                              af ? lane(pr.w, q) : 0.f, bi, c, r, rc, gv);
}

// pair_grad<USE_SA, NN, BF16> for one pixel on the packed chain, both
// lanes holding the pixel (px, py; pxf, pyf as floats) and lane 0's values
// used: K2-bf16's reverse walk, one pixel a thread. A packed op for one
// pixel is one instruction where the one-pixel chain spends three (the
// float32 op and the rounding's two).
template <bool USE_SA, bool NN>
GS_FN void pair_grad1(const float* sa, int j, int gi, int start, int stop,
                      bf2 px, bf2 py, float pxf, float pyf, bf2 T_in,
                      bool live, const BlockInfo& bi, const Cot& c,
                      const Run& r, RevCarry& rc, float* gv) {
  const bool in[2] = {true, false};
  const bool lv[2] = {live, live};
  const Run rr[2] = {r, r};
  Prep2 pr;
  pair_prep2<USE_SA>(sa, j, gi, start, stop, px, py, T_in, lv, in, rr, pr);
  lane_grad<USE_SA, NN>(sa, j, pr, 0, pxf, pyf, bi, c, r, rc, gv);
}

// K2-bf16's first pass runs two pixels a thread, its reverse walk one:
// the first pass leaves each pixel's BlockInfo, step mask and record
// count in `info` ([INFO_C][P] words, pixel-major) for the pixel's own
// thread.
constexpr int INFO_C = 9;

GS_FN void put_info(float* info, int p, const BlockInfo& bi,
                    const StepMask& m, int n_rec) {
  const unsigned w[INFO_C] = {fbits(bi.E), fbits(bi.T_out), fbits(bi.mm_out),
                              (unsigned)bi.med_j, m.w0, m.w1, m.w2, m.w3,
                              (unsigned)n_rec};
  for (int k = 0; k < INFO_C; ++k) info[k * P + p] = bitsf(w[k]);
}

GS_FN void get_info(const float* info, int p, BlockInfo& bi, StepMask& m,
                    int& n_rec) {
  unsigned w[INFO_C];
  for (int k = 0; k < INFO_C; ++k) w[k] = fbits(info[k * P + p]);
  bi.E = bitsf(w[0]);
  bi.T_out = bitsf(w[1]);
  bi.mm_out = bitsf(w[2]);
  bi.med_j = (int)w[3];
  m = {w[4], w[5], w[6], w[7]};
  n_rec = (int)w[8];
}

#if defined(__CUDACC__)
// Stage block b of the slab as stage_block<BF16P> does, then the walk of
// one packed CTA (K1-bf16, K3-bf16): forward_walk with two pixels a
// thread. Each thread rounds the pieces of block k that it copied itself
// (its own cp.async groups are complete and visible to it after the
// wait), before the barrier that publishes the block.
__device__ __forceinline__ void round_staged(float* sa) {
  constexpr int Q = CHUNK / 4;
  for (int e = threadIdx.x; e < ATTR_C * Q; e += blockDim.x) {
    const int c = e / Q, q = e % Q;
    if (c >= GRAD_C) continue;  // the cull radii and the pad rows
    float4* v = reinterpret_cast<float4*>(sa + c * CHUNK + 4 * q);
    float4 x = *v;
    x.x = stage_word(x.x);
    x.y = stage_word(x.y);
    x.z = stage_word(x.z);
    x.w = stage_word(x.w);
    *v = x;
  }
}

template <bool STASH, bool USE_SA, bool NN>
__device__ __forceinline__ int forward_walk2(
    PixState s[2], float* sa, const float* __restrict__ attrs, int R,
    const TileWalk& tw, int nblk, bf2 px, bf2 py, float* stash, int soff,
    int stash_rows) {
  const int t = threadIdx.x;
  const int64_t g0 = (int64_t)tw.blk0 * CHUNK;
  if (nblk > 0) {
    stage_async(sa, attrs, R, g0);
    sa[RHO_ROW * CHUNK + t] = rho_cull<BF16>(attrs[17 * R + g0 + t]);
  }
  int k = 0;
  for (; k < nblk; ++k) {
    if (__syncthreads_and(s[0].done >= 0.5f && s[1].done >= 0.5f)) break;
    const int64_t gstart = g0 + (int64_t)k * CHUNK;
    float* cur = sa + (k & 1) * (ATTR_C * CHUNK);
    float* nxt = sa + ((k + 1) & 1) * (ATTR_C * CHUNK);
    const bool more = k + 1 < nblk;
    float op_next = 0.f;
    if (more) {
      stage_async(nxt, attrs, R, gstart + CHUNK);
      op_next = attrs[17 * R + gstart + CHUNK + t];
    }
    if (STASH && soff + k < stash_rows) {
      float* row = stash + ((int64_t)(soff + k) * STASH_C) * P + 2 * t;
      store_stash(row, P, s[0]);
      store_stash(row + 1, P, s[1]);
    }
    if (more) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    round_staged(cur);
    __syncthreads();
    composite_block2<USE_SA, NN>(s, cur, (int)gstart, tw.start, tw.stop, px,
                                 py);
    if (more) nxt[RHO_ROW * CHUNK + t] = rho_cull<BF16>(op_next);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  return k;
}

#endif

}  // namespace gs
