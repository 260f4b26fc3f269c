// The per-pixel math of the rasterizer kernels, run on the CPU.
//
// Compiles raster_common.cuh as plain C++ and drives composite_block /
// pair_grad exactly as raster_forward.cu (K1) and raster_backward.cu (K2,
// and K5: K1's walk capped at reforward_blocks into a scratch stash, then
// K2's sweep over it) do, through the same helpers for the range clamps (tile_walk), the
// stash guards (stash_rows, swept_blocks), the pixel coordinates and the
// stash and output rows. Only the CTA is replaced: its threads become
// sequential loops over the pixels, the tile's exit barrier a loop over
// the pixels' `done`, and the warp-tree sum of a pair's gradient over the
// pixels a sum in pixel order (so the gradient rounds differently from
// the kernel's). The CPU tests build it with g++ and hold its forward,
// stash, kexit and hand-derived gradient to the plain PyTorch versions
// (torch.autograd for the gradient), so the kernels' arithmetic is
// checked without a card.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC
//       -o libpixel_math_host.so pixel_math_host.cpp   (one command)
#include <cstdint>
#include <vector>

#include "raster_common.cuh"

using namespace gs;

static void stage(float* sa, const float* attrs, int64_t R, int64_t gstart) {
  for (int c = 0; c < ATTR_C; ++c)
    for (int j = 0; j < CHUNK; ++j) sa[c * CHUNK + j] = attrs[c * R + gstart + j];
}

template <bool USE_SA, bool NN>
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
    stage(sa.data(), attrs, R, gstart);
    for (int p = 0; p < P; ++p)
      composite_block<USE_SA, NN, false>(
          s[p], sa.data(), (int)gstart, tw.start, tw.stop,
          pixel_x(t, tiles_x, p), pixel_y(t, tiles_x, p), nullptr, nullptr,
          nullptr);
  }
  if (want_stash) kexit[i] = k;
  for (int p = 0; p < P; ++p)
    store_out<USE_SA>(out + (int64_t)i * OUT_C * P + p, P, s[p]);
}

template <bool USE_SA, bool NN>
static void backward_tile(int i, const float* attrs, int R, const int* ids,
                          const int* ts, const int* te, const int* soff,
                          const int* kexit, const float* stash, int stash_rows,
                          const float* dstate0, int tiles_x, float* d_attrs) {
  const int t = ids[i];
  const TileWalk tw = tile_walk(ts[i], te[i], R);
  std::vector<float> sa(ATTR_C * CHUNK);
  std::vector<float> cumx(P * CHUNK), pre1(P * CHUNK), pre2(P * CHUNK);
  std::vector<Cot> c(P);
  std::vector<BlockInfo> bi(P);
  std::vector<RevCarry> rc(P);
  std::vector<float> T_in(P);
  std::vector<char> live(P);
  for (int p = 0; p < P; ++p)
    c[p] = load_cot(dstate0 + (int64_t)i * OUT_C * P + p, P);
  const int K = swept_blocks(kexit[i], tw.nblk, soff[i], stash_rows);
  for (int k = K - 1; k >= 0; --k) {
    const int64_t gstart = (int64_t)(tw.blk0 + k) * CHUNK;
    stage(sa.data(), attrs, R, gstart);
    for (int p = 0; p < P; ++p) {
      PixState s = state_from_stash(
          stash + ((int64_t)(soff[i] + k) * STASH_C) * P + p, P);
      T_in[p] = s.T;
      live[p] = s.done < 0.5f;
      bi[p] = composite_block<USE_SA, NN, true>(
          s, sa.data(), (int)gstart, tw.start, tw.stop,
          pixel_x(t, tiles_x, p), pixel_y(t, tiles_x, p), &cumx[p * CHUNK],
          &pre1[p * CHUNK], &pre2[p * CHUNK]);
      rc[p] = {0.f, 0.f, 0.f, 0.f};
    }
    for (int j = CHUNK - 1; j >= 0; --j) {
      float acc[GRAD_C] = {0.f};
      for (int p = 0; p < P; ++p) {
        float gv[GRAD_C];
        pair_grad<USE_SA, NN>(sa.data(), j, (int)gstart + j, tw.start,
                              tw.stop, pixel_x(t, tiles_x, p),
                              pixel_y(t, tiles_x, p), T_in[p], live[p], bi[p],
                              c[p], &cumx[p * CHUNK], &pre1[p * CHUNK],
                              &pre2[p * CHUNK], rc[p], gv);
        for (int q = 0; q < GRAD_C; ++q) acc[q] += gv[q];
      }
      const int gi = (int)gstart + j;
      if (gi >= tw.start && gi < tw.stop)
        for (int q = 0; q < GRAD_C; ++q) d_attrs[(int64_t)q * R + gi] = acc[q];
    }
    for (int p = 0; p < P; ++p) carry_cotangent<USE_SA, NN>(c[p], bi[p], rc[p]);
  }
}

extern "C" void host_raster_forward(const float* attrs, int R, const int* ids,
                                    const int* ts, const int* te,
                                    const int* soff, int n_sub, int tiles_x,
                                    int use_sa, int nn, int want_stash,
                                    int stash_rows, float* out, float* stash,
                                    int* kexit) {
  for (int i = 0; i < n_sub; ++i) {
#define GS_CALL(SA, N) forward_tile<SA, N>(i, attrs, R, ids, ts, te, soff, \
    tiles_x, want_stash != 0, stash_rows, out, stash, kexit)
    if (use_sa) { if (nn) GS_CALL(true, true); else GS_CALL(true, false); }
    else { if (nn) GS_CALL(false, true); else GS_CALL(false, false); }
#undef GS_CALL
  }
}

extern "C" void host_raster_backward(const float* attrs, int R, const int* ids,
                                     const int* ts, const int* te,
                                     const int* soff, const int* kexit,
                                     const float* stash, int stash_rows,
                                     const float* dstate0, int n_sub,
                                     int tiles_x, int use_sa, int nn,
                                     float* d_attrs) {
  for (int i = 0; i < n_sub; ++i) {
#define GS_CALL(SA, N) backward_tile<SA, N>(i, attrs, R, ids, ts, te, soff, \
    kexit, stash, stash_rows, dstate0, tiles_x, d_attrs)
    if (use_sa) { if (nn) GS_CALL(true, true); else GS_CALL(true, false); }
    else { if (nn) GS_CALL(false, true); else GS_CALL(false, false); }
#undef GS_CALL
  }
}

// K5 on the CPU: for every tile of the grid (tile i = ids i), the
// re-forward into `stash` (K1's layout, rows [soff, soff + kexit)) and
// then the reverse sweep over the blocks it composited.
extern "C" void host_raster_backward_restash(const float* attrs, int R,
                                             const int* ts, const int* te,
                                             const int* soff, float* stash,
                                             int stash_rows,
                                             const float* dstate0, int n_tiles,
                                             int tiles_x, int use_sa, int nn,
                                             float* d_attrs) {
  std::vector<int> ids(n_tiles), kexit(n_tiles);
  for (int i = 0; i < n_tiles; ++i) ids[i] = i;
  std::vector<float> out((int64_t)n_tiles * OUT_C * P);
  for (int i = 0; i < n_tiles; ++i) {
#define GS_CALL(SA, N)                                                      \
    forward_tile<SA, N>(i, attrs, R, ids.data(), ts, te, soff, tiles_x,    \
                        true, stash_rows, out.data(), stash, kexit.data(),  \
                        true);                                              \
    backward_tile<SA, N>(i, attrs, R, ids.data(), ts, te, soff,            \
                         kexit.data(), stash, stash_rows, dstate0, tiles_x, \
                         d_attrs)
    if (use_sa) { if (nn) { GS_CALL(true, true); } else { GS_CALL(true, false); } }
    else { if (nn) { GS_CALL(false, true); } else { GS_CALL(false, false); } }
#undef GS_CALL
  }
}
