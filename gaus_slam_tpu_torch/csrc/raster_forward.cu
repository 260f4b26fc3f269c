// K1 / K3: tile-sorted 2DGS surfel compositing, forward.
//
// Replaces the Pallas kernels gaus_slam_tpu/ops/pallas_forward.py::
// raster_forward_stash (K1, kernel _kernel_stash) and ::raster_forward
// (K3, kernel _kernel). K3 is K1 with the stash writes compiled out
// (template flag STASH). The compute type (F32 or BF16, the JAX kernels'
// compute_dtype, pallas_forward.py:110 and :297) picks the kernel: F32
// runs raster_forward_kernel, BF16 the packed raster_forward_bf16x2_kernel
// (below), with the bf16 cull radius.
//
// Design: one CTA per rendered tile, one thread per pixel (16x16 = 256).
// The tile's pair range [start, stop) is walked in 128-aligned global
// blocks floor(start/128) .. ceil(stop/128); each block's [24, 128]
// attributes are staged once in shared memory, with each pair's cull
// radius in the slab's pad row, and every pixel composites the block
// (raster_common.cuh: forward_walk and composite_block, which K5's
// re-forward shares). The tile exits when
// every pixel is done (__syncthreads_and). K1 writes each block's incoming
// carry (T done D D2 M1 M2 mm) to the stash at row soff[tile] + k and the
// number of blocks it composited to kexit.
//
// What bounds it: per (pair, pixel) the function needs ~45 f32 FLOP and
// 4 special-function results (reciprocal, exp, log1p, exp) where the cull
// test keeps the pair, 25 FLOP where it rejects it, and ~38 FLOP and 3
// more for each pair the pixel accepts (SA's fusion), against 96 bytes of
// attributes read once per block by the whole CTA: bound by operations
// (chip_smoke.py computes the bound from the run's data). On phase 2's
// data the cull rejects ~95% of the walk and a pixel touches ~5.6 pairs
// of a block; a walk over every pair spends half its time in SA's second
// pass over the whole block, and most of the rest in the geometry and
// special functions of pairs that miss the pixel. So the first pass tests
// the cull before any geometry (a warp whose lanes all reject a pair skips
// it) and records the touched pairs in a 128-bit step mask; SA's second
// pass re-runs those pairs only; a pixel that is done, or (F32) has
// triggered inside the block, leaves it. None of these changes a bit of out, stash or kexit
// (raster_common.cuh argues each; the CPU tests build the math without
// them, -DGS_FWD_NO_SKIP, and compare). The attributes stay in shared
// memory (broadcast reads), two blocks of them: block k + 1 is copied
// with cp.async while block k is composited. The pixel state stays in
// registers; four CTAs per SM, the compiler's own choice: asking for five
// or six spilled and was slower (tools/kernel_ab.py).
// BF16 (K1-bf16, K3-bf16) is a kernel of its own, the same walk packed
// for Hopper's bf16x2 arithmetic (raster_bf16x2.cuh): a CTA of 128
// threads, two horizontally neighbouring pixels a thread in the two
// lanes of a bf16x2 word, every rounded op of the chain one packed op for
// both, the block rounded once as it is staged, and the cull and the step
// on one geometry per (pair, pixel). Its out, stash and kexit are the
// one-pixel BF16 walk's bit for bit. The function's bound counts its FLOP
// at the packed bf16 rate (chip_smoke.py).
#include "raster_bf16x2.cuh"

using namespace gs;

template <bool STASH, bool USE_SA, bool NN>
__global__ void __launch_bounds__(P) raster_forward_kernel(
    const float* __restrict__ attrs, int R, const int* __restrict__ tile_ids,
    const int* __restrict__ tstart, const int* __restrict__ tstop,
    const int* __restrict__ soff, int tiles_x, int stash_rows,
    float* __restrict__ out, float* __restrict__ stash,
    int* __restrict__ kexit) {
  __shared__ float sa[FWD_SA];
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

// CTAs per SM the packed kernel's launch bounds ask for: 8 of 128
// threads, as many warps as the f32 kernel's 4 of 256. That caps a thread
// at 64 registers, and the two pixels' state spills 200-400 bytes; left
// to itself ptxas takes 96-116 registers without spills and 4 CTAs fit,
// which measured 17% slower (tools/kernel_ab.py).
constexpr int FWD2_MIN_BLOCKS = 8;

template <bool STASH, bool USE_SA, bool NN>
__global__ void __launch_bounds__(P2, FWD2_MIN_BLOCKS)
raster_forward_bf16x2_kernel(
    const float* __restrict__ attrs, int R, const int* __restrict__ tile_ids,
    const int* __restrict__ tstart, const int* __restrict__ tstop,
    const int* __restrict__ soff, int tiles_x, int stash_rows,
    float* __restrict__ out, float* __restrict__ stash,
    int* __restrict__ kexit) {
  __shared__ float sa[FWD_SA];
  const int i = blockIdx.x;
  const int p = 2 * threadIdx.x;
  const int t = tile_ids[i];
  const TileWalk tw = tile_walk(tstart[i], tstop[i], R);
  const bf2 px = pack2(pixel_x(t, tiles_x, p), pixel_x(t, tiles_x, p + 1));
  const bf2 py = pack2(pixel_y(t, tiles_x, p), pixel_y(t, tiles_x, p + 1));

  PixState s[2] = {init_state(), init_state()};
  const int k = forward_walk2<STASH, USE_SA, NN>(
      s, sa, attrs, R, tw, tw.nblk, px, py, stash, STASH ? soff[i] : 0,
      stash_rows);
  if (STASH && threadIdx.x == 0) kexit[i] = k;
  store_out<USE_SA>(out + (int64_t)i * OUT_C * P + p, P, s[0]);
  store_out<USE_SA>(out + (int64_t)i * OUT_C * P + p + 1, P, s[1]);
}

template <bool STASH>
static void launch(bool bf16, bool use_sa, bool nn, dim3 grid,
                   cudaStream_t st, const float* attrs, int R, const int* ids,
                   const int* ts, const int* te, const int* soff, int tiles_x,
                   int stash_rows, float* out, float* stash, int* kexit) {
#define GS_LAUNCH(SA, N)                                                   \
  if (bf16)                                                                \
    raster_forward_bf16x2_kernel<STASH, SA, N><<<grid, P2, 0, st>>>(       \
        attrs, R, ids, ts, te, soff, tiles_x, stash_rows, out, stash,      \
        kexit);                                                            \
  else                                                                     \
    raster_forward_kernel<STASH, SA, N><<<grid, P, 0, st>>>(               \
        attrs, R, ids, ts, te, soff, tiles_x, stash_rows, out, stash, kexit)
  if (use_sa) {
    if (nn) { GS_LAUNCH(true, true); } else { GS_LAUNCH(true, false); }
  } else {
    if (nn) { GS_LAUNCH(false, true); } else { GS_LAUNCH(false, false); }
  }
#undef GS_LAUNCH
}

extern "C" int raster_forward(const float* attrs, int R, const int* tile_ids,
                              const int* tile_start, const int* tile_stop,
                              const int* soff, int n_sub, int tiles_x,
                              int use_sa, int need_normal, int want_stash,
                              int stash_rows, int bf16, float* out,
                              float* stash, int* kexit, cudaStream_t stream) {
  if (n_sub > 0) {
    dim3 grid(n_sub);
#define GS_LAUNCH(STASH)                                                    \
  launch<STASH>(bf16, use_sa, need_normal, grid, stream, attrs, R,          \
                tile_ids, tile_start, tile_stop, soff, tiles_x, stash_rows, \
                out, stash, kexit)
    if (want_stash) GS_LAUNCH(true); else GS_LAUNCH(false);
#undef GS_LAUNCH
  }
  return (int)cudaGetLastError();
}
