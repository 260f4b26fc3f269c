// K1 / K3: tile-sorted 2DGS surfel compositing, forward.
//
// Replaces the Pallas kernels gaus_slam_tpu/ops/pallas_forward.py::
// raster_forward_stash (K1, kernel _kernel_stash) and ::raster_forward
// (K3, kernel _kernel). K3 is K1 with the stash writes compiled out
// (template flag STASH).
//
// Design: one CTA per rendered tile, one thread per pixel (16x16 = 256).
// The tile's pair range [start, stop) is walked in 128-aligned global
// blocks floor(start/128) .. ceil(stop/128) with a validity mask; each
// block's [24, 128] attributes are staged once in shared memory and every
// pixel composites the block sequentially (raster_common.cuh,
// forward_walk, which K5's re-forward shares). The tile
// exits when every pixel is done (__syncthreads_and). K1 writes each
// block's incoming carry (T done D D2 M1 M2 mm) to the stash at row
// soff[tile] + k and the number of blocks it composited to kexit.
//
// What bounds it: per (pair, pixel) the function needs ~45 f32 FLOP and
// 4 special-function results (reciprocal, exp, log1p, exp), and ~38 FLOP
// and 3 more for each pair the pixel accepts (SA's fusion), against 96
// bytes of attributes read once per block by the whole CTA: bound by
// operations, the special-function unit first (chip_smoke.py computes the
// bound from the run's data). This design spends more: SA's median target
// needs a second pass over the block, geometry included. It keeps the
// attributes in shared memory (broadcast reads), the pixel state in
// registers, and stops a tile as soon as all its pixels terminate.
// Pixels that terminated early still walk the remaining pairs of the
// block (masked): a later change can compact them.
#include "raster_common.cuh"

using namespace gs;

template <bool STASH, bool USE_SA, bool NN>
__global__ void __launch_bounds__(P) raster_forward_kernel(
    const float* __restrict__ attrs, int R, const int* __restrict__ tile_ids,
    const int* __restrict__ tstart, const int* __restrict__ tstop,
    const int* __restrict__ soff, int tiles_x, int stash_rows,
    float* __restrict__ out, float* __restrict__ stash,
    int* __restrict__ kexit) {
  __shared__ float sa[ATTR_C * CHUNK];
  const int i = blockIdx.x;
  const int p = threadIdx.x;
  const int t = tile_ids[i];
  const TileWalk tw = tile_walk(tstart[i], tstop[i], R);
  const float px = pixel_x(t, tiles_x, p);
  const float py = pixel_y(t, tiles_x, p);

  PixState s = init_state();
  const int k = forward_walk<STASH, USE_SA, NN>(
      s, sa, attrs, R, tw, tw.nblk, px, py, stash, STASH ? soff[i] : 0,
      stash_rows);
  if (STASH && p == 0) kexit[i] = k;
  store_out<USE_SA>(out + (int64_t)i * OUT_C * P + p, P, s);
}

template <bool STASH>
static void launch(bool use_sa, bool nn, dim3 grid, cudaStream_t st,
                   const float* attrs, int R, const int* ids, const int* ts,
                   const int* te, const int* soff, int tiles_x,
                   int stash_rows, float* out, float* stash, int* kexit) {
#define GS_LAUNCH(SA, N)                                                  \
  raster_forward_kernel<STASH, SA, N><<<grid, P, 0, st>>>(                \
      attrs, R, ids, ts, te, soff, tiles_x, stash_rows, out, stash, kexit)
  if (use_sa) {
    if (nn) GS_LAUNCH(true, true); else GS_LAUNCH(true, false);
  } else {
    if (nn) GS_LAUNCH(false, true); else GS_LAUNCH(false, false);
  }
#undef GS_LAUNCH
}

extern "C" int raster_forward(const float* attrs, int R, const int* tile_ids,
                              const int* tile_start, const int* tile_stop,
                              const int* soff, int n_sub, int tiles_x,
                              int use_sa, int need_normal, int want_stash,
                              int stash_rows, float* out, float* stash,
                              int* kexit, cudaStream_t stream) {
  if (n_sub > 0) {
    dim3 grid(n_sub);
    if (want_stash)
      launch<true>(use_sa, need_normal, grid, stream, attrs, R, tile_ids,
                   tile_start, tile_stop, soff, tiles_x, stash_rows, out,
                   stash, kexit);
    else
      launch<false>(use_sa, need_normal, grid, stream, attrs, R, tile_ids,
                    tile_start, tile_stop, soff, tiles_x, stash_rows, out,
                    stash, kexit);
  }
  return (int)cudaGetLastError();
}
