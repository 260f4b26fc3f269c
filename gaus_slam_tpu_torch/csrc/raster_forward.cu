// K1 / K3: tile-sorted 2DGS surfel compositing, forward.
//
// Replaces the Pallas kernels gaus_slam_tpu/ops/pallas_forward.py::
// raster_forward_stash (K1, kernel _kernel_stash) and ::raster_forward
// (K3, kernel _kernel). K3 is K1 with the stash writes compiled out
// (template flag STASH). The compute type CT (F32 or BF16, the JAX
// kernels' compute_dtype, pallas_forward.py:110 and :297) is a template
// flag too: BF16 runs the per-pair chain in bf16 (raster_common.cuh), with
// the bf16 cull radius.
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
// BF16 is the simple form: float32 arithmetic with a rounding after each
// op of the chain (no packed bf16x2), and the cull test evaluates the
// chain's own rounded rho2d and rho3d; it needs the same operations as
// F32, so it is bound as F32 is.
#include "raster_common.cuh"

using namespace gs;

template <bool STASH, bool USE_SA, bool NN, class CT>
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
  const float px = CT::r(pixel_x(t, tiles_x, p));
  const float py = CT::r(pixel_y(t, tiles_x, p));

  PixState s = init_state();
  const int k = forward_walk<STASH, USE_SA, NN, CT>(
      s, sa, attrs, R, tw, tw.nblk, px, py, stash, STASH ? soff[i] : 0,
      stash_rows);
  if (STASH && p == 0) kexit[i] = k;
  store_out<USE_SA>(out + (int64_t)i * OUT_C * P + p, P, s);
}

template <bool STASH, class CT>
static void launch(bool use_sa, bool nn, dim3 grid, cudaStream_t st,
                   const float* attrs, int R, const int* ids, const int* ts,
                   const int* te, const int* soff, int tiles_x,
                   int stash_rows, float* out, float* stash, int* kexit) {
#define GS_LAUNCH(SA, N)                                                  \
  raster_forward_kernel<STASH, SA, N, CT><<<grid, P, 0, st>>>(            \
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
                              int stash_rows, int bf16, float* out,
                              float* stash, int* kexit, cudaStream_t stream) {
  if (n_sub > 0) {
    dim3 grid(n_sub);
#define GS_LAUNCH(STASH, CT)                                                \
  launch<STASH, CT>(use_sa, need_normal, grid, stream, attrs, R, tile_ids,  \
                    tile_start, tile_stop, soff, tiles_x, stash_rows, out,  \
                    stash, kexit)
    if (bf16) {
      if (want_stash) GS_LAUNCH(true, BF16); else GS_LAUNCH(false, BF16);
    } else {
      if (want_stash) GS_LAUNCH(true, F32); else GS_LAUNCH(false, F32);
    }
#undef GS_LAUNCH
  }
  return (int)cudaGetLastError();
}
