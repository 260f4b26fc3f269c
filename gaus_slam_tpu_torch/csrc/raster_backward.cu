// K2: reverse sweep of the 2DGS compositor with a hand-derived vjp.
//
// Replaces the Pallas kernel gaus_slam_tpu/ops/pallas_backward.py::
// raster_backward_stash (kernel _kernel_stashed), which traced jax.vjp of
// compositing.composite_chunk inside the kernel. CUDA has no autodiff, so
// the vjp of every op of composite_chunk is written out by hand
// (raster_common.cuh: pair_grad, carry_cotangent), with the same detach
// boundaries: the okf / below / median / SA-conf masks carry
// no gradient; the alpha clamp passes its gradient through; the median is
// detached inside SA's fusion and live in the middepth output; SA's
// statistics (D, D2 prefixes, T_pref) are detached inside conf.
//
// Design: one CTA per rendered tile, one thread per pixel, three CTAs per
// SM (the tiles' sweeps are near-equal in length on the frontend's data:
// launching the longest first measured no gain). For each block
// k = kexit-1 .. 0 the CTA restages the block's attributes (with a
// cull radius per pair) and reloads the block's incoming carry from the
// forward's stash. A first pass re-walks the block (pair_step,
// bit-identical to K1 because the library is built with -fmad=false) for
// the block's BlockInfo, keeping in registers a 128-bit mask of the pairs
// that touched the pixel and, in a ring in shared memory
// ([3][REC_CAP][256] floats), the running values (log-sum and statistics
// prefixes) before each of them: the pixel's records. A pair that surely
// misses a pixel (a conservative test on its two squared distances,
// without the division or the exp) skips its geometry. The reverse walk
// then visits the pairs last first with suffix accumulators, turning the
// pixel state's cotangent into per-(pair, pixel) attribute gradients and
// the cotangent of the block's incoming state (the carry for block k-1);
// it skips the pairs outside a pixel's mask, a warp skips a pair none of
// its pixels touched, and a pixel that more than REC_CAP pairs of the
// block touched re-runs the block's masked pairs from its start for the
// records the ring no longer holds. The first cotangent comes from the
// forward's output and the loss cotangent in the kernel (cot_from_out).
// T_pref is recomputed as T_in * exp(cum), never by dividing by (1-a).
//
// The compute type CT (F32 or BF16, pallas_backward.py:344's
// compute_dtype) is a template flag: under BF16 the first pass, the
// re-runs and pair_grad's recompute repeat K1-BF16's rounded chain bit for
// bit (the same pair_step), and the vjp runs in float32 on those
// bf16-rounded values (the JAX kernel rounds every cotangent to bf16 as
// it differentiates its bf16 chain; K2-BF16 does not, so the two agree
// to a tolerance, not to bits). K5 has no compute type: it runs F32.
//
// Per-pair sum over the 256 pixels: a warp reduce-scatter (31 shuffles,
// lane q ends with row q's warp sum; a warp whose lanes all miss the pair
// skips it), then the 8 warp partials of a round are summed in shared
// memory in a fixed order — deterministic, no atomics.
//
// Ordering hazard of the TPU version (a 128-block shared by two
// neighbouring tiles was a read-modify-write on a sequential grid): here
// the tiles of one launch have disjoint pair ranges, and a pair's
// gradient is exactly zero in every tile but the one whose range holds
// it (pair_valid masks it out). So each CTA stores only the columns of
// its own range, plain stores and no atomics; no second pass is needed,
// and the result does not depend on the order the tiles run in.
// Columns no tile swept (past kexit, or outside tile_ids) keep the zeros
// the wrapper allocated.
//
// What bounds it: operations, as the forward. The function needs the
// forward's per-pair values and ~82 more FLOP per accepted (pair, pixel)
// for the vjp and the sum over pixels; this design also recomputes the
// geometry of the pairs the cull keeps in the first pass and of the
// touched pairs in the walk. chip_smoke.py computes the bound.
//
// K5 replaces pallas_backward.py::raster_backward (kernel _kernel), the
// backward of the reference render backend, whose forward keeps no stash.
// It is two launches on the stream: the re-forward
// (raster_reforward_kernel: K1's block walk, forward_walk, the same code,
// so its carries equal K1's bit for bit, over at most MAX_CHUNKS_PER_TILE
// blocks) stores each block's incoming carry in a global scratch at K1's
// stash layout and the number of blocks in a scratch kexit; then K2's
// sweep kernel runs over them. The TPU kept the carries in a 512-block
// VMEM stash, which would not fit a CTA's shared memory here. Two kernels,
// so that the re-forward runs as K1 does (five CTAs per SM, no spill)
// and not under the sweep's 80 registers and three CTAs per SM: K5 takes
// K1's time plus K2's (tools/kernel_ab.py). The function is K2's plus one
// forward, so it is bound as K2 is; chip_smoke.py gives K2's needed work
// as its bound.
#include "raster_common.cuh"

using namespace gs;

constexpr int WARPS = P / 32;
// CTAs per SM the launch bounds ask for (the shared memory below allows
// 3). At 3 the compiler caps a thread at 80 registers and spills a few
// words; that measured faster than 2 CTAs at ~100 registers without spills.
constexpr int MIN_BLOCKS = 3;

// Shared memory of one CTA, in floats: the staged block, the pixels'
// rings of records and the warp partials of one round.
constexpr int SM_SA = ATTR_C * CHUNK;
constexpr int SM_REC = 3 * REC_CAP * P;
constexpr int SM_PART = WARPS * BWD_GROUP * GRAD_C;
constexpr size_t SWEEP_SMEM = sizeof(float) * (SM_SA + SM_REC + SM_PART);

// The reverse sweep of one CTA over blocks K-1 .. 0 of its tile (K2 and
// K5): block k's incoming carry comes from stash row soff + k; c enters
// as the cotangent of the tile's final pixel state.
template <bool USE_SA, bool NN, class CT>
__device__ __forceinline__ void reverse_sweep(
    float* smem, const float* __restrict__ attrs, int R, const TileWalk& tw,
    int K, const float* stash, int soff, float px, float py,
    Cot c, float* __restrict__ d_attrs) {
  float* sa = smem;
  float* rec = sa + SM_SA;
  float* part = rec + SM_REC;  // [WARPS][BWD_GROUP][GRAD_C]
  const int p = threadIdx.x;
  const int lane = p & 31, warp = p >> 5;
  const int start = tw.start, stop = tw.stop;
  for (int k = K - 1; k >= 0; --k) {
    const int gstart = (tw.blk0 + k) * CHUNK;
    const float* srow = stash + ((int64_t)(soff + k) * STASH_C) * P + p;
    __syncthreads();
    stage_block<CT>(sa, attrs, R, gstart);
    const PixState s = state_from_stash(srow, P);
    const float T_in = s.T;
    const bool live = s.done < 0.5f;
    __syncthreads();
    StepMask mask;
    int n_rec;
    const BlockInfo bi = block_info<USE_SA, CT>(s, sa, gstart, start, stop,
                                                px, py, p, rec, mask, n_rec);
    // the ring holds records n_lo .. n_rec - 1 (per-thread columns: no
    // barrier)
    int n_lo = n_rec > REC_CAP ? n_rec - REC_CAP : 0;
    RevCarry rc = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int g = BWD_NGROUP - 1; g >= 0; --g) {
      const int g0 = gstart + g * BWD_GROUP;
      // a group outside the tile's range holds none of its pairs (the
      // same for every thread of the CTA)
      if (g0 >= stop || g0 + BWD_GROUP <= start) continue;
#pragma unroll 1
      for (int jj = BWD_GROUP - 1; jj >= 0; --jj) {
        const int j = g * BWD_GROUP + jj;
        const bool in_mask = mask_test(mask, j);
        float* prow = part + (warp * BWD_GROUP + jj) * GRAD_C;
        if (!__any_sync(0xffffffffu, in_mask)) {
          if (lane < GRAD_C) prow[lane] = 0.f;
          continue;
        }
        float gv[GRAD_C];
        if (in_mask) {
          const int n = --n_rec;
          if (n < n_lo) {
            n_lo = n + 1 > REC_CAP ? n + 1 - REC_CAP : 0;
            refill_records<USE_SA, CT>(state_from_stash(srow, P), sa, gstart,
                                       start, stop, px, py, p, mask, n_lo,
                                       n + 1, rec);
          }
          pair_grad<USE_SA, NN, CT>(sa, j, g0 + jj, start, stop, px, py,
                                    T_in, live, bi, c, get_rec(rec, n, p), rc,
                                    gv);
        } else {
#pragma unroll
          for (int q = 0; q < GRAD_C; ++q) gv[q] = 0.f;
        }
        const float row = warp_reduce_scatter(gv, lane);
        if (lane < GRAD_C) prow[lane] = row;
      }
      __syncthreads();
      // sum the 8 warp partials in a fixed order; store only the columns
      // of this tile's own range
      for (int e = p; e < BWD_GROUP * GRAD_C; e += P) {
        const int q = e / BWD_GROUP, jj = e % BWD_GROUP;
        const int gi = g0 + jj;
        float v = 0.f;
#pragma unroll
        for (int w8 = 0; w8 < WARPS; ++w8)
          v += part[(w8 * BWD_GROUP + jj) * GRAD_C + q];
        if (gi >= start && gi < stop) d_attrs[(int64_t)q * R + gi] = v;
      }
      __syncthreads();
    }
    carry_cotangent<USE_SA, NN>(c, bi, rc);
  }
}

template <bool USE_SA, bool NN, class CT>
__global__ void __launch_bounds__(P, MIN_BLOCKS) raster_backward_kernel(
    const float* __restrict__ attrs, int R, const int* __restrict__ tile_ids, const int* __restrict__ tstart,
    const int* __restrict__ tstop, const int* __restrict__ soff,
    const int* __restrict__ kexit, const float* __restrict__ stash,
    int stash_rows, const float* __restrict__ saved_out,
    const float* __restrict__ d_out, int tiles_x,
    float* __restrict__ d_attrs) {
  extern __shared__ float smem[];
  const int i = blockIdx.x;
  const int p = threadIdx.x;
  const int t = tile_ids[i];
  // ranges clamped to the slab and blocks to the stash, as in K1
  const TileWalk tw = tile_walk(tstart[i], tstop[i], R);
  const int64_t row = (int64_t)i * OUT_C * P + p;
  const Cot c = cot_from_out<USE_SA>(saved_out + row, d_out + row, P);
  reverse_sweep<USE_SA, NN, CT>(
      smem, attrs, R, tw, swept_blocks(kexit[i], tw.nblk, soff[i], stash_rows),
      stash, soff[i], CT::r(pixel_x(t, tiles_x, p)),
      CT::r(pixel_y(t, tiles_x, p)), c, d_attrs);
}

// K5's re-forward: each block's incoming carry into the global scratch
// `stash` at K1's layout, the blocks composited into `kexit` and the
// tile's index into `ids` (the sweep's tile ids), for every tile of the
// grid (tile i = CTA i), as K1 walks them.
template <bool USE_SA, bool NN>
__global__ void __launch_bounds__(P) raster_reforward_kernel(
    const float* __restrict__ attrs, int R, const int* __restrict__ tstart,
    const int* __restrict__ tstop, const int* __restrict__ soff,
    float* __restrict__ stash, int stash_rows, int tiles_x,
    int* __restrict__ kexit, int* __restrict__ ids) {
  __shared__ float sa[FWD_SA];
  const int i = blockIdx.x;
  const int p = threadIdx.x;
  const TileWalk tw = tile_walk(tstart[i], tstop[i], R);
  PixState s = init_state();
  const int k = forward_walk<true, USE_SA, NN, F32>(
      s, sa, attrs, R, tw, reforward_blocks(tw.nblk), pixel_x(i, tiles_x, p),
      pixel_y(i, tiles_x, p), stash, soff[i], stash_rows);
  if (p == 0) {
    kexit[i] = k;
    ids[i] = i;
  }
}

// Launch with the sweep's dynamic shared memory (above the 48 KB default,
// so each instantiation opts in first); returns the first error.
template <typename Kernel, typename... Args>
static cudaError_t launch_sweep(Kernel kernel, int n, cudaStream_t stream,
                                Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SWEEP_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<n, P, SWEEP_SMEM, stream>>>(args...);
  return cudaGetLastError();
}

extern "C" int raster_backward(const float* attrs, int R, const int* tile_ids,
                               const int* tile_start, const int* tile_stop,
                               const int* soff, const int* kexit,
                               const float* stash, int stash_rows,
                               const float* saved_out, const float* d_out,
                               int n_sub, int tiles_x, int use_sa,
                               int need_normal, int bf16, float* d_attrs,
                               cudaStream_t stream) {
  if (n_sub <= 0) return (int)cudaGetLastError();
  cudaError_t err;
#define GS_LAUNCH(SA, N, CT)                                                \
  err = launch_sweep(raster_backward_kernel<SA, N, CT>, n_sub, stream,      \
                     attrs, R, tile_ids, tile_start, tile_stop, soff, kexit, \
                     stash, stash_rows, saved_out, d_out, tiles_x, d_attrs)
#define GS_BY_CT(SA, N) \
  if (bf16) GS_LAUNCH(SA, N, BF16); else GS_LAUNCH(SA, N, F32)
  if (use_sa) {
    if (need_normal) { GS_BY_CT(true, true); } else { GS_BY_CT(true, false); }
  } else {
    if (need_normal) { GS_BY_CT(false, true); } else { GS_BY_CT(false, false); }
  }
#undef GS_BY_CT
#undef GS_LAUNCH
  return (int)err;
}

extern "C" int raster_backward_restash(const float* attrs, int R,
                                       const int* tile_start,
                                       const int* tile_stop, const int* soff,
                                       float* stash, int stash_rows,
                                       int* kexit, int* ids,
                                       const float* saved_out,
                                       const float* d_out, int n_tiles,
                                       int tiles_x, int use_sa,
                                       int need_normal, float* d_attrs,
                                       cudaStream_t stream) {
  if (n_tiles <= 0) return (int)cudaGetLastError();
  cudaError_t err;
#define GS_LAUNCH(SA, N)                                                    \
  raster_reforward_kernel<SA, N><<<n_tiles, P, 0, stream>>>(                \
      attrs, R, tile_start, tile_stop, soff, stash, stash_rows, tiles_x,    \
      kexit, ids);                                                          \
  err = cudaGetLastError();                                                 \
  if (err == cudaSuccess)                                                   \
    err = launch_sweep(raster_backward_kernel<SA, N, F32>, n_tiles, stream, \
                       attrs, R, (const int*)ids, tile_start,               \
                       tile_stop, soff, (const int*)kexit,                  \
                       (const float*)stash, stash_rows, saved_out, d_out,   \
                       tiles_x, d_attrs)
  if (use_sa) {
    if (need_normal) { GS_LAUNCH(true, true); } else { GS_LAUNCH(true, false); }
  } else {
    if (need_normal) { GS_LAUNCH(false, true); } else { GS_LAUNCH(false, false); }
  }
#undef GS_LAUNCH
  return (int)err;
}

// The sweep's dynamic shared memory per CTA, for the build report.
extern "C" int sweep_smem_bytes() { return (int)SWEEP_SMEM; }
