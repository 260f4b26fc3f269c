// The per-pixel math of the rasterizer kernels, run on the CPU.
//
// Compiles raster_common.cuh as plain C++ and drives it exactly as
// raster_forward.cu (K1) and raster_backward.cu (K2, and K5: K1's walk
// capped at reforward_blocks into a scratch stash, then K2's sweep over
// it) do, through the same helpers for the range clamps (tile_walk), the
// stash guards (stash_rows, swept_blocks), the pixel coordinates, the
// stash and output rows and the first cotangent (cot_from_out). The
// backward mirrors K2's sweep step for step: the first pass with its cull
// (block_info: step mask, each pixel's ring of records), the reverse walk
// with its re-run of a pixel's earlier records (refill_records) and
// pair_grad's fmaf arithmetic, the warp reduce-scatter of each pair's
// rows (rs_keep / rs_send over 32 simulated lanes, skipped for a warp that
// no pixel of which the pair touched) and the fixed-order sum of the 8
// warp partials, so its gradient sums in the kernel's order. Only the
// CTA is replaced: its threads become sequential loops over the pixels,
// and the tile's exit barrier a loop over the pixels' `done`. The CPU
// tests build it with g++ and hold its forward, stash, kexit and
// hand-derived gradient to the plain PyTorch versions (torch.autograd for
// the gradient), so the kernels' arithmetic is checked without a card.
// The forward and backward entry points have a _bf16 twin that runs the
// bf16 compute dtype as the kernels do, packed (raster_bf16x2.cuh: the
// forward walk and the sweep's first pass two pixels a thread, the
// sweep's reverse walk one pixel a thread on the packed chain's lane 0),
// and a _bf16_1px twin that runs
// the one-pixel BF16 walk (raster_common.cuh's compute type BF16), the
// form the packed walk must equal bit for bit (raster_common.cuh's
// bf16_round is PyTorch's and __float2bfloat16_rn's rounding, done on the
// bits).
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC
//       -o libpixel_math_host.so pixel_math_host.cpp   (one command)
#include <cstdint>
#include <vector>

#include "raster_bf16x2.cuh"

using namespace gs;

constexpr int WARPS = P / 32;

// stage_block: the block, with the walks' cull radii in row RHO_ROW
template <class CT>
static void stage(float* sa, const float* attrs, int64_t R, int64_t gstart) {
  for (int c = 0; c < ATTR_C; ++c)
    for (int j = 0; j < CHUNK; ++j)
      sa[c * CHUNK + j] = c == RHO_ROW
                              ? rho_cull<CT>(attrs[17 * R + gstart + j])
                              : CT::stage(attrs[c * R + gstart + j]);
}

// The kernel's warp_reduce_scatter over 32 simulated lanes: v[lane][slot]
// in, out[lane] = the warp's sum of slot `lane`. Each step first takes
// every lane's sent half (what __shfl_xor_sync delivers), then adds it to
// the partner's kept half.
static void warp_reduce_scatter_lanes(float (*v)[RS_SLOTS], float* out) {
  for (int h = RS_SLOTS / 2; h > 0; h >>= 1) {
    float sent[32][RS_SLOTS / 2];
    for (int lane = 0; lane < 32; ++lane)
      for (int i = 0; i < h; ++i) sent[lane][i] = rs_send(v[lane], lane, h, i);
    for (int lane = 0; lane < 32; ++lane)
      for (int i = 0; i < h; ++i)
        v[lane][i] = rs_keep(v[lane], lane, h, i) + sent[lane ^ h][i];
  }
  for (int lane = 0; lane < 32; ++lane) out[lane] = v[lane][0];
}

template <bool USE_SA, bool NN, class CT>
static void forward_tile(int i, const float* attrs, int R, const int* ids,
                         const int* ts, const int* te, const int* soff,
                         int tiles_x, bool want_stash, int stash_rows,
                         float* out, float* stash, int* kexit,
                         bool reforward = false) {
  const int t = ids[i];
  const TileWalk tw = tile_walk(ts[i], te[i], R);
  const int nblk = reforward ? reforward_blocks(tw.nblk) : tw.nblk;
  std::vector<PixState> s(P, init_state());
  std::vector<float> sa(ATTR_C * CHUNK);
  int k = 0;
  for (; k < nblk; ++k) {
    bool all_done = true;
    for (int p = 0; p < P; ++p) all_done = all_done && s[p].done >= 0.5f;
    if (all_done) break;
    const int64_t gstart = (int64_t)(tw.blk0 + k) * CHUNK;
    if (want_stash && soff[i] + k < stash_rows)
      for (int p = 0; p < P; ++p)
        store_stash(stash + ((int64_t)(soff[i] + k) * STASH_C) * P + p, P,
                    s[p]);
    stage<CT>(sa.data(), attrs, R, gstart);
    for (int p = 0; p < P; ++p)
      composite_block<USE_SA, NN, CT>(s[p], sa.data(), (int)gstart, tw.start,
                                      tw.stop, CT::r(pixel_x(t, tiles_x, p)),
                                      CT::r(pixel_y(t, tiles_x, p)));
  }
  if (want_stash) kexit[i] = k;
  for (int p = 0; p < P; ++p)
    store_out<USE_SA>(out + (int64_t)i * OUT_C * P + p, P, s[p]);
}

template <bool USE_SA, bool NN, class CT>
static void backward_tile(int i, const float* attrs, int R, const int* ids,
                          const int* ts, const int* te, const int* soff,
                          const int* kexit, const float* stash, int stash_rows,
                          const float* saved_out, const float* d_out,
                          int tiles_x, float* d_attrs) {
  const int t = ids[i];
  const TileWalk tw = tile_walk(ts[i], te[i], R);
  std::vector<float> sa(ATTR_C * CHUNK);
  std::vector<float> rec(3 * REC_CAP * P);
  std::vector<Cot> c(P);
  std::vector<BlockInfo> bi(P);
  std::vector<RevCarry> rc(P);
  std::vector<StepMask> mask(P);
  std::vector<PixState> s(P);
  std::vector<int> n_rec(P), n_lo(P);
  std::vector<float> px(P), py(P);
  std::vector<float> part(WARPS * BWD_GROUP * GRAD_C);
  for (int p = 0; p < P; ++p) {
    const int64_t row = (int64_t)i * OUT_C * P + p;
    c[p] = cot_from_out<USE_SA>(saved_out + row, d_out + row, P);
    px[p] = CT::r(pixel_x(t, tiles_x, p));
    py[p] = CT::r(pixel_y(t, tiles_x, p));
  }
  const int K = swept_blocks(kexit[i], tw.nblk, soff[i], stash_rows);
  for (int k = K - 1; k >= 0; --k) {
    const int gstart = (tw.blk0 + k) * CHUNK;
    stage<CT>(sa.data(), attrs, R, gstart);
    for (int p = 0; p < P; ++p) {
      s[p] = state_from_stash(
          stash + ((int64_t)(soff[i] + k) * STASH_C) * P + p, P);
      bi[p] = block_info<USE_SA, CT>(s[p], sa.data(), gstart, tw.start, tw.stop,
                                 px[p], py[p], p, rec.data(), mask[p],
                                 n_rec[p]);
      n_lo[p] = n_rec[p] > REC_CAP ? n_rec[p] - REC_CAP : 0;
      rc[p] = {0.f, 0.f, 0.f, 0.f};
    }
    for (int g = BWD_NGROUP - 1; g >= 0; --g) {
      const int g0 = gstart + g * BWD_GROUP;
      if (g0 >= tw.stop || g0 + BWD_GROUP <= tw.start) continue;
      for (int jj = BWD_GROUP - 1; jj >= 0; --jj) {
        const int j = g * BWD_GROUP + jj;
        for (int w8 = 0; w8 < WARPS; ++w8) {
          float* prow = &part[(w8 * BWD_GROUP + jj) * GRAD_C];
          float v[32][RS_SLOTS] = {};
          bool any = false;
          for (int lane = 0; lane < 32; ++lane) {
            const int p = w8 * 32 + lane;
            if (!mask_test(mask[p], j)) continue;
            any = true;
            const int n = --n_rec[p];
            if (n < n_lo[p]) {
              n_lo[p] = n + 1 > REC_CAP ? n + 1 - REC_CAP : 0;
              refill_records<USE_SA, CT>(s[p], sa.data(), gstart, tw.start,
                                         tw.stop, px[p], py[p], p, mask[p],
                                         n_lo[p], n + 1, rec.data());
            }
            pair_grad<USE_SA, NN, CT>(sa.data(), j, g0 + jj, tw.start, tw.stop,
                                  px[p], py[p], s[p].T, s[p].done < 0.5f,
                                  bi[p], c[p], get_rec(rec.data(), n, p),
                                  rc[p], v[lane]);
          }
          float rows[32] = {};
          if (any) warp_reduce_scatter_lanes(v, rows);
          for (int q = 0; q < GRAD_C; ++q) prow[q] = rows[q];
        }
      }
      for (int q = 0; q < GRAD_C; ++q)
        for (int jj = 0; jj < BWD_GROUP; ++jj) {
          const int gi = g0 + jj;
          float sum = 0.f;
          for (int w8 = 0; w8 < WARPS; ++w8)
            sum += part[(w8 * BWD_GROUP + jj) * GRAD_C + q];
          if (gi >= tw.start && gi < tw.stop) d_attrs[(int64_t)q * R + gi] = sum;
        }
    }
    for (int p = 0; p < P; ++p) carry_cotangent<USE_SA, NN>(c[p], bi[p], rc[p]);
  }
}

// K1-bf16 / K3-bf16 on the CPU: forward_tile with 128 threads of two
// pixels each (composite_block2), the block staged as stage_word does.
template <bool USE_SA, bool NN>
static void forward_tile2(int i, const float* attrs, int R, const int* ids,
                          const int* ts, const int* te, const int* soff,
                          int tiles_x, bool want_stash, int stash_rows,
                          float* out, float* stash, int* kexit) {
  const int t = ids[i];
  const TileWalk tw = tile_walk(ts[i], te[i], R);
  std::vector<PixState> s(P, init_state());
  std::vector<float> sa(ATTR_C * CHUNK);
  int k = 0;
  for (; k < tw.nblk; ++k) {
    bool all_done = true;
    for (int p = 0; p < P; ++p) all_done = all_done && s[p].done >= 0.5f;
    if (all_done) break;
    const int64_t gstart = (int64_t)(tw.blk0 + k) * CHUNK;
    if (want_stash && soff[i] + k < stash_rows)
      for (int p = 0; p < P; ++p)
        store_stash(stash + ((int64_t)(soff[i] + k) * STASH_C) * P + p, P,
                    s[p]);
    stage<BF16P>(sa.data(), attrs, R, gstart);
    for (int th = 0; th < P2; ++th)
      composite_block2<USE_SA, NN>(
          &s[2 * th], sa.data(), (int)gstart, tw.start, tw.stop,
          pack2(pixel_x(t, tiles_x, 2 * th), pixel_x(t, tiles_x, 2 * th + 1)),
          pack2(pixel_y(t, tiles_x, 2 * th), pixel_y(t, tiles_x, 2 * th + 1)));
  }
  if (want_stash) kexit[i] = k;
  for (int p = 0; p < P; ++p)
    store_out<USE_SA>(out + (int64_t)i * OUT_C * P + p, P, s[p]);
}

// K2-bf16 on the CPU, as the kernel runs it: backward_tile with each
// block's first pass two pixels a thread (block_info2 over 128 simulated
// threads; records in the pixel's ring column) and the reverse walk one
// pixel a thread on the packed chain's lane 0 (pair_grad1,
// refill_records2), its rows reduce-scattered per warp of 32 pixels and
// the 8 warp partials summed as backward_tile sums them.
template <bool USE_SA, bool NN>
static void backward_tile2(int i, const float* attrs, int R, const int* ids,
                           const int* ts, const int* te, const int* soff,
                           const int* kexit, const float* stash,
                           int stash_rows, const float* saved_out,
                           const float* d_out, int tiles_x, float* d_attrs) {
  const int tile = ids[i];
  const TileWalk tw = tile_walk(ts[i], te[i], R);
  std::vector<float> sa(ATTR_C * CHUNK);
  std::vector<float> rec(3 * REC_CAP * P);
  std::vector<Cot> c(P);
  std::vector<BlockInfo> bi(P);
  std::vector<RevCarry> rc(P);
  std::vector<StepMask> mask(P);
  std::vector<PixState> s(P);
  std::vector<int> n_rec(P), n_lo(P);
  std::vector<float> pxf(P), pyf(P);
  std::vector<float> part(WARPS * BWD_GROUP * GRAD_C);
  for (int p = 0; p < P; ++p) {
    const int64_t row = (int64_t)i * OUT_C * P + p;
    c[p] = cot_from_out<USE_SA>(saved_out + row, d_out + row, P);
    pxf[p] = BF16::r(pixel_x(tile, tiles_x, p));
    pyf[p] = BF16::r(pixel_y(tile, tiles_x, p));
  }
  const int K = swept_blocks(kexit[i], tw.nblk, soff[i], stash_rows);
  for (int k = K - 1; k >= 0; --k) {
    const int gstart = (tw.blk0 + k) * CHUNK;
    stage<BF16P>(sa.data(), attrs, R, gstart);
    for (int p = 0; p < P; ++p) {
      s[p] = state_from_stash(
          stash + ((int64_t)(soff[i] + k) * STASH_C) * P + p, P);
      rc[p] = {0.f, 0.f, 0.f, 0.f};
    }
    for (int th = 0; th < P2; ++th) {
      const int p = 2 * th;
      const int col[2] = {p, p + 1};
      block_info2<USE_SA>(&s[p], sa.data(), gstart, tw.start, tw.stop,
                          pack2(pxf[p], pxf[p + 1]), pack2(pyf[p], pyf[p + 1]),
                          col, rec.data(), &mask[p], &n_rec[p], &bi[p]);
    }
    for (int p = 0; p < P; ++p)
      n_lo[p] = n_rec[p] > REC_CAP ? n_rec[p] - REC_CAP : 0;
    for (int g = BWD_NGROUP - 1; g >= 0; --g) {
      const int g0 = gstart + g * BWD_GROUP;
      if (g0 >= tw.stop || g0 + BWD_GROUP <= tw.start) continue;
      for (int jj = BWD_GROUP - 1; jj >= 0; --jj) {
        const int j = g * BWD_GROUP + jj;
        for (int w8 = 0; w8 < WARPS; ++w8) {
          float* prow = &part[(w8 * BWD_GROUP + jj) * GRAD_C];
          float v[32][RS_SLOTS] = {};
          bool any = false;
          for (int lane = 0; lane < 32; ++lane) {
            const int p = w8 * 32 + lane;
            if (!mask_test(mask[p], j)) continue;
            any = true;
            const bf2 px1 = pack2(pxf[p], pxf[p]), py1 = pack2(pyf[p], pyf[p]);
            const int n = --n_rec[p];
            if (n < n_lo[p]) {
              n_lo[p] = n + 1 > REC_CAP ? n + 1 - REC_CAP : 0;
              const PixState s1[2] = {s[p], s[p]};
              refill_records2<USE_SA>(0, s1, sa.data(), gstart, tw.start,
                                      tw.stop, px1, py1, p, mask[p], n_lo[p],
                                      n + 1, rec.data());
            }
            pair_grad1<USE_SA, NN>(sa.data(), j, g0 + jj, tw.start, tw.stop,
                                   px1, py1, pxf[p], pyf[p],
                                   pack2(s[p].T, s[p].T), s[p].done < 0.5f,
                                   bi[p], c[p], get_rec(rec.data(), n, p),
                                   rc[p], v[lane]);
          }
          float rows[32] = {};
          if (any) warp_reduce_scatter_lanes(v, rows);
          for (int q = 0; q < GRAD_C; ++q) prow[q] = rows[q];
        }
      }
      for (int q = 0; q < GRAD_C; ++q)
        for (int jj = 0; jj < BWD_GROUP; ++jj) {
          const int gi = g0 + jj;
          float sum = 0.f;
          for (int w8 = 0; w8 < WARPS; ++w8)
            sum += part[(w8 * BWD_GROUP + jj) * GRAD_C + q];
          if (gi >= tw.start && gi < tw.stop) d_attrs[(int64_t)q * R + gi] = sum;
        }
    }
    for (int p = 0; p < P; ++p) carry_cotangent<USE_SA, NN>(c[p], bi[p], rc[p]);
  }
}

template <class CT>
static void raster_forward_ct(const float* attrs, int R, const int* ids,
                              const int* ts, const int* te, const int* soff,
                              int n_sub, int tiles_x, int use_sa, int nn,
                              int want_stash, int stash_rows, float* out,
                              float* stash, int* kexit) {
  for (int i = 0; i < n_sub; ++i) {
#define GS_CALL(SA, N) forward_tile<SA, N, CT>(i, attrs, R, ids, ts, te,  \
    soff, tiles_x, want_stash != 0, stash_rows, out, stash, kexit)
    if (use_sa) { if (nn) GS_CALL(true, true); else GS_CALL(true, false); }
    else { if (nn) GS_CALL(false, true); else GS_CALL(false, false); }
#undef GS_CALL
  }
}

template <class CT>
static void raster_backward_ct(const float* attrs, int R, const int* ids,
                               const int* ts, const int* te, const int* soff,
                               const int* kexit, const float* stash,
                               int stash_rows, const float* saved_out,
                               const float* d_out, int n_sub, int tiles_x,
                               int use_sa, int nn, float* d_attrs) {
  for (int i = 0; i < n_sub; ++i) {
#define GS_CALL(SA, N) backward_tile<SA, N, CT>(i, attrs, R, ids, ts, te, \
    soff, kexit, stash, stash_rows, saved_out, d_out, tiles_x, d_attrs)
    if (use_sa) { if (nn) GS_CALL(true, true); else GS_CALL(true, false); }
    else { if (nn) GS_CALL(false, true); else GS_CALL(false, false); }
#undef GS_CALL
  }
}

#define GS_FORWARD_ARGS                                                     \
  const float *attrs, int R, const int *ids, const int *ts, const int *te, \
      const int *soff, int n_sub, int tiles_x, int use_sa, int nn,         \
      int want_stash, int stash_rows, float *out, float *stash, int *kexit
#define GS_FORWARD_PASS                                                    \
  attrs, R, ids, ts, te, soff, n_sub, tiles_x, use_sa, nn, want_stash,    \
      stash_rows, out, stash, kexit
#define GS_BACKWARD_ARGS                                                    \
  const float *attrs, int R, const int *ids, const int *ts, const int *te, \
      const int *soff, const int *kexit, const float *stash,               \
      int stash_rows, const float *saved_out, const float *d_out,          \
      int n_sub, int tiles_x, int use_sa, int nn, float *d_attrs
#define GS_BACKWARD_PASS                                                   \
  attrs, R, ids, ts, te, soff, kexit, stash, stash_rows, saved_out, d_out, \
      n_sub, tiles_x, use_sa, nn, d_attrs

extern "C" void host_raster_forward(GS_FORWARD_ARGS) {
  raster_forward_ct<F32>(GS_FORWARD_PASS);
}

extern "C" void host_raster_forward_bf16(GS_FORWARD_ARGS) {
  for (int i = 0; i < n_sub; ++i) {
#define GS_CALL(SA, N) forward_tile2<SA, N>(i, attrs, R, ids, ts, te, soff, \
    tiles_x, want_stash != 0, stash_rows, out, stash, kexit)
    if (use_sa) { if (nn) GS_CALL(true, true); else GS_CALL(true, false); }
    else { if (nn) GS_CALL(false, true); else GS_CALL(false, false); }
#undef GS_CALL
  }
}

extern "C" void host_raster_forward_bf16_1px(GS_FORWARD_ARGS) {
  raster_forward_ct<BF16>(GS_FORWARD_PASS);
}

extern "C" void host_raster_backward(GS_BACKWARD_ARGS) {
  raster_backward_ct<F32>(GS_BACKWARD_PASS);
}

extern "C" void host_raster_backward_bf16(GS_BACKWARD_ARGS) {
  for (int i = 0; i < n_sub; ++i) {
#define GS_CALL(SA, N) backward_tile2<SA, N>(i, attrs, R, ids, ts, te, soff, \
    kexit, stash, stash_rows, saved_out, d_out, tiles_x, d_attrs)
    if (use_sa) { if (nn) GS_CALL(true, true); else GS_CALL(true, false); }
    else { if (nn) GS_CALL(false, true); else GS_CALL(false, false); }
#undef GS_CALL
  }
}

extern "C" void host_raster_backward_bf16_1px(GS_BACKWARD_ARGS) {
  raster_backward_ct<BF16>(GS_BACKWARD_PASS);
}

// K5 on the CPU: for every tile of the grid (tile i = ids i), the
// re-forward into `stash` (K1's layout, rows [soff, soff + kexit)) and
// then the reverse sweep over the blocks it composited.
extern "C" void host_raster_backward_restash(const float* attrs, int R,
                                             const int* ts, const int* te,
                                             const int* soff, float* stash,
                                             int stash_rows,
                                             const float* saved_out,
                                             const float* d_out, int n_tiles,
                                             int tiles_x, int use_sa, int nn,
                                             float* d_attrs) {
  std::vector<int> ids(n_tiles), kexit(n_tiles);
  for (int i = 0; i < n_tiles; ++i) ids[i] = i;
  std::vector<float> out((int64_t)n_tiles * OUT_C * P);
  for (int i = 0; i < n_tiles; ++i) {
#define GS_CALL(SA, N)                                                      \
    forward_tile<SA, N, F32>(i, attrs, R, ids.data(), ts, te, soff,        \
                             tiles_x, true, stash_rows, out.data(), stash, \
                             kexit.data(), true);                          \
    backward_tile<SA, N, F32>(i, attrs, R, ids.data(), ts, te, soff,       \
                              kexit.data(), stash, stash_rows, saved_out,  \
                              d_out, tiles_x, d_attrs)
    if (use_sa) { if (nn) { GS_CALL(true, true); } else { GS_CALL(true, false); } }
    else { if (nn) { GS_CALL(false, true); } else { GS_CALL(false, false); } }
#undef GS_CALL
  }
}

// The warp reduce-scatter alone, for the tests: in [32 lanes][32 slots],
// out [32] (lane l's result, the sum over lanes of slot l).
extern "C" void host_warp_reduce_scatter(const float* in, float* out) {
  float v[32][RS_SLOTS];
  for (int lane = 0; lane < 32; ++lane)
    for (int q = 0; q < RS_SLOTS; ++q) v[lane][q] = in[lane * RS_SLOTS + q];
  warp_reduce_scatter_lanes(v, out);
}

// cot_from_out for every pixel of n tiles, written in the row layout of
// ops/raster_backward.py::finalize_cotangents ([n, OUT_C, P]), for the
// tests.
extern "C" void host_cot_from_out(const float* saved_out, const float* d_out,
                                  int n, int use_sa, float* d0) {
  for (int64_t e = 0; e < (int64_t)n * P; ++e) {
    const int64_t row = (e / P) * OUT_C * P + e % P;
    const Cot c = use_sa ? cot_from_out<true>(saved_out + row, d_out + row, P)
                         : cot_from_out<false>(saved_out + row, d_out + row, P);
    const float v[OUT_C] = {c.T, 0.f, c.r, c.g, c.b, c.nx, c.ny, c.nz,
                            c.D, c.D2, c.M1, c.M2, c.dist, c.mm, 0.f, 0.f};
    for (int q = 0; q < OUT_C; ++q) d0[row + q * P] = v[q];
  }
}

// The backward's cull over every (pair, pixel) of the given tiles' blocks:
// out[0] (pair, pixel) evaluations, out[1] culled, out[2] culled yet
// passing the alpha test (none may), out[3] the most pairs of one block
// that pass it for one pixel (a live pixel's records), for the tests.
template <class CT>
static void cull_counts(const float* attrs, int R, const int* ids,
                        const int* ts, const int* te, int n_sub, int tiles_x,
                        long long* out) {
  std::vector<float> sa(ATTR_C * CHUNK);
  out[0] = out[1] = out[2] = out[3] = 0;
  for (int i = 0; i < n_sub; ++i) {
    const TileWalk tw = tile_walk(ts[i], te[i], R);
    for (int k = 0; k < tw.nblk; ++k) {
      const int gstart = (tw.blk0 + k) * CHUNK;
      stage<CT>(sa.data(), attrs, R, gstart);
      for (int p = 0; p < P; ++p) {
        long long touched = 0;
        for (int j = 0; j < CHUNK; ++j) {
          const float px = CT::r(pixel_x(ids[i], tiles_x, p));
          const float py = CT::r(pixel_y(ids[i], tiles_x, p));
          Geom g;
          pair_geom<CT>(sa.data(), j, px, py, g);
          const bool culled = pair_culled<CT>(sa.data(), j, px, py);
          const int gi = gstart + j;
          const bool ok = pair_ok(g, gi >= tw.start && gi < tw.stop, true);
          out[0] += 1;
          out[1] += culled;
          out[2] += culled && pair_ok(g, true, true);
          touched += ok;
        }
        out[3] = touched > out[3] ? touched : out[3];
      }
    }
  }
}

extern "C" void host_cull_counts(const float* attrs, int R, const int* ids,
                                 const int* ts, const int* te, int n_sub,
                                 int tiles_x, long long* out) {
  cull_counts<F32>(attrs, R, ids, ts, te, n_sub, tiles_x, out);
}

extern "C" void host_cull_counts_bf16(const float* attrs, int R,
                                      const int* ids, const int* ts,
                                      const int* te, int n_sub, int tiles_x,
                                      long long* out) {
  cull_counts<BF16>(attrs, R, ids, ts, te, n_sub, tiles_x, out);
}

// The packed walks' division-free cull test over every (pair, pixel) of
// the given tiles' blocks: out[0] evaluations, out[1] those it culls
// (rho2d > lim and lane_far_ray), out[2] those among them that
// lane_culled keeps (none may), for the tests.
extern "C" void host_far_ray_counts(const float* attrs, int R, const int* ids,
                                    const int* ts, const int* te, int n_sub,
                                    int tiles_x, long long* out) {
  std::vector<float> sa(ATTR_C * CHUNK);
  out[0] = out[1] = out[2] = 0;
  for (int i = 0; i < n_sub; ++i) {
    const TileWalk tw = tile_walk(ts[i], te[i], R);
    for (int k = 0; k < tw.nblk; ++k) {
      const int gstart = (tw.blk0 + k) * CHUNK;
      stage<BF16P>(sa.data(), attrs, R, gstart);
      for (int th = 0; th < P2; ++th) {
        const int p = 2 * th;
        const bf2 px = pack2(pixel_x(ids[i], tiles_x, p),
                             pixel_x(ids[i], tiles_x, p + 1));
        const bf2 py = pack2(pixel_y(ids[i], tiles_x, p),
                             pixel_y(ids[i], tiles_x, p + 1));
        for (int j = 0; j < CHUNK; ++j) {
          Geom2 g;
          geom2(sa.data(), j, px, py, g);
          const float lim = sa[RHO_ROW * CHUNK + j];
          for (int q = 0; q < 2; ++q) {
            const bool far =
                lane(g.rho2d, q) > lim && lane_far_ray(g, q, lim);
            out[0] += 1;
            out[1] += far;
            out[2] += far && !lane_culled(g, q, lim);
          }
        }
      }
    }
  }
}

// bf16_round over n floats, for the tests (against PyTorch's rounding).
extern "C" void host_bf16_round(const float* in, float* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = bf16_round(in[i]);
}

// The packed type's ops over n operand pairs, for the tests: out[0, n)
// add2, [n, 2n) sub2, [2n, 3n) mul2, each lane a[i], b[i] (the host's
// float32 op rounded to bf16, the premise of the packed walk).
extern "C" void host_bf16x2_ops(const float* a, const float* b, float* out,
                                int n) {
  for (int i = 0; i < n; ++i) {
    const bf2 x = {{a[i], a[i]}}, y = {{b[i], b[i]}};
    out[i] = lane(add2(x, y), 0);
    out[n + i] = lane(sub2(x, y), 1);
    out[2 * n + i] = lane(mul2(x, y), 0);
  }
}
