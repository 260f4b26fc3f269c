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
// Design: one CTA per rendered tile, one thread per pixel. For each block
// k = kexit-1 .. 0 the CTA restages the block's attributes, reloads the
// block's incoming carry from the forward's stash and reruns the block
// forward (composite_block, bit-identical to K1 because the library is
// built with -fmad=false), recording per pair the exclusive log-sum and
// the exclusive statistics in per-thread local arrays. It then walks the
// block's pairs in reverse with suffix accumulators, turning the pixel
// state's cotangent into per-(pair, pixel) attribute gradients and the
// cotangent of the block's incoming state (the carry for block k-1).
// T_pref is recomputed as T_in * exp(cumx), never by dividing by (1-a).
//
// Per-pair reduction over the 256 pixels: warp shuffles (a warp whose
// lanes all miss the pair skips them), then the 8 warp partials of 32
// pairs are summed in shared memory in a fixed order — deterministic.
//
// Ordering hazard of the TPU version (a 128-block shared by two
// neighbouring tiles was a read-modify-write on a sequential grid): here
// the tiles of one launch have disjoint pair ranges, and a pair's
// gradient is exactly zero in every tile but the one whose range holds
// it (pair_valid masks it out). So each CTA stores only the columns of
// its own range, plain stores and no atomics; no second pass is needed.
// Columns no tile swept (past kexit, or outside tile_ids) keep the zeros
// the wrapper allocated.
//
// What bounds it: operations, as the forward. The function needs the
// forward's per-pair values and ~82 more FLOP per accepted (pair, pixel)
// for the vjp and the sum over pixels; this design also recomputes the
// pair's geometry in pair_grad and runs 21 warp reductions per pair that
// any pixel of a warp touched. chip_smoke.py computes the bound.
//
// K5 (raster_backward_restash_kernel) replaces pallas_backward.py::
// raster_backward (kernel _kernel), the backward of the reference render
// backend, whose forward keeps no stash. Phase A re-runs K1's block walk
// (forward_walk, the same code, so its carries equal K1's bit for bit)
// over at most MAX_CHUNKS_PER_TILE blocks, storing each block's incoming
// carry in a global scratch at K1's stash layout; the TPU kept it in a
// 512-block VMEM stash, which would not fit a CTA's shared memory here.
// Phase B is K2's reverse sweep over that scratch. The function is K2's
// plus one forward, so it is bound as K2 is; chip_smoke.py gives K2's
// needed work as its bound.
#include "raster_common.cuh"

using namespace gs;

constexpr int WARPS = P / 32;
constexpr int GROUP = 32;  // pairs reduced per shared-memory round

// The reverse sweep of one CTA over blocks K-1 .. 0 of its tile (K2 and
// K5): block k's incoming carry comes from stash row soff + k; c enters
// as the cotangent of the tile's final pixel state.
template <bool USE_SA, bool NN>
__device__ __forceinline__ void reverse_sweep(
    float* sa, const float* __restrict__ attrs, int R, const TileWalk& tw,
    int K, const float* stash, int soff, float px, float py,
    Cot c, float* __restrict__ d_attrs) {
  __shared__ float part[WARPS][GROUP][GRAD_C];
  // per-pixel, per-pair records of the block's forward recompute
  // (per-thread local memory)
  float cumx[CHUNK], pre1[CHUNK], pre2[CHUNK];
  const int p = threadIdx.x;
  const int lane = p & 31, warp = p >> 5;
  const int start = tw.start, stop = tw.stop;
  for (int k = K - 1; k >= 0; --k) {
    const int64_t gstart = (int64_t)(tw.blk0 + k) * CHUNK;
    __syncthreads();
    stage_block(sa, attrs, R, gstart);
    PixState s = state_from_stash(
        stash + ((int64_t)(soff + k) * STASH_C) * P + p, P);
    const float T_in = s.T;
    const bool live = s.done < 0.5f;
    __syncthreads();
    const BlockInfo bi = composite_block<USE_SA, NN, true>(
        s, sa, (int)gstart, start, stop, px, py, cumx, pre1, pre2);

    RevCarry rc = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int grp = CHUNK / GROUP - 1; grp >= 0; --grp) {
#pragma unroll 1
      for (int jj = GROUP - 1; jj >= 0; --jj) {
        const int j = grp * GROUP + jj;
        float gv[GRAD_C];
        const bool okf = pair_grad<USE_SA, NN>(
            sa, j, (int)gstart + j, start, stop, px, py, T_in, live, bi, c,
            cumx, pre1, pre2, rc, gv);
        // reduce over the warp's 32 pixels (skipped when none touched)
        if (__any_sync(0xffffffffu, okf)) {
#pragma unroll
          for (int q = 0; q < GRAD_C; ++q) {
            float v = gv[q];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v += __shfl_down_sync(0xffffffffu, v, off);
            if (lane == 0) part[warp][jj][q] = v;
          }
        } else if (lane == 0) {
#pragma unroll
          for (int q = 0; q < GRAD_C; ++q) part[warp][jj][q] = 0.f;
        }
      }
      __syncthreads();
      // sum the 8 warp partials in a fixed order; store only the columns
      // of this tile's own range
      for (int e = p; e < GROUP * GRAD_C; e += P) {
        const int q = e / GROUP, jj = e % GROUP;
        const int gi = (int)gstart + grp * GROUP + jj;
        float v = 0.f;
#pragma unroll
        for (int w8 = 0; w8 < WARPS; ++w8) v += part[w8][jj][q];
        if (gi >= start && gi < stop) d_attrs[(int64_t)q * R + gi] = v;
      }
      __syncthreads();
    }
    carry_cotangent<USE_SA, NN>(c, bi, rc);
  }
}

template <bool USE_SA, bool NN>
__global__ void __launch_bounds__(P) raster_backward_kernel(
    const float* __restrict__ attrs, int R, const int* __restrict__ tile_ids,
    const int* __restrict__ tstart, const int* __restrict__ tstop,
    const int* __restrict__ soff, const int* __restrict__ kexit,
    const float* __restrict__ stash, int stash_rows,
    const float* __restrict__ dstate0, int tiles_x,
    float* __restrict__ d_attrs) {
  __shared__ float sa[ATTR_C * CHUNK];
  const int i = blockIdx.x;
  const int p = threadIdx.x;
  const int t = tile_ids[i];
  // ranges clamped to the slab and blocks to the stash, as in K1
  const TileWalk tw = tile_walk(tstart[i], tstop[i], R);
  const Cot c = load_cot(dstate0 + (int64_t)i * OUT_C * P + p, P);
  reverse_sweep<USE_SA, NN>(
      sa, attrs, R, tw, swept_blocks(kexit[i], tw.nblk, soff[i], stash_rows),
      stash, soff[i], pixel_x(t, tiles_x, p), pixel_y(t, tiles_x, p), c,
      d_attrs);
}

// K5: the re-forward (phase A) writes each block's incoming carry into
// the global scratch `stash` at K1's layout, then the reverse sweep
// (phase B) reads it back. Every tile of the grid, tile i = CTA i.
template <bool USE_SA, bool NN>
__global__ void __launch_bounds__(P) raster_backward_restash_kernel(
    const float* __restrict__ attrs, int R, const int* __restrict__ tstart,
    const int* __restrict__ tstop, const int* __restrict__ soff,
    float* stash, int stash_rows,
    const float* __restrict__ dstate0, int tiles_x,
    float* __restrict__ d_attrs) {
  __shared__ float sa[ATTR_C * CHUNK];
  const int i = blockIdx.x;
  const int p = threadIdx.x;
  const TileWalk tw = tile_walk(tstart[i], tstop[i], R);
  const float px = pixel_x(i, tiles_x, p);
  const float py = pixel_y(i, tiles_x, p);
  PixState s = init_state();
  // each thread reads back only the stash entries it wrote itself, so
  // program order suffices between the phases (no __restrict__ on the
  // scratch: it must not be read through the non-coherent cache)
  const int kex = forward_walk<true, USE_SA, NN>(
      s, sa, attrs, R, tw, reforward_blocks(tw.nblk), px, py, stash, soff[i],
      stash_rows);
  const Cot c = load_cot(dstate0 + (int64_t)i * OUT_C * P + p, P);
  reverse_sweep<USE_SA, NN>(
      sa, attrs, R, tw, swept_blocks(kex, tw.nblk, soff[i], stash_rows),
      stash, soff[i], px, py, c, d_attrs);
}

extern "C" int raster_backward(const float* attrs, int R, const int* tile_ids,
                               const int* tile_start, const int* tile_stop,
                               const int* soff, const int* kexit,
                               const float* stash, int stash_rows,
                               const float* dstate0, int n_sub, int tiles_x,
                               int use_sa, int need_normal, float* d_attrs,
                               cudaStream_t stream) {
  if (n_sub > 0) {
    dim3 grid(n_sub);
#define GS_LAUNCH(SA, N)                                                    \
  raster_backward_kernel<SA, N><<<grid, P, 0, stream>>>(                    \
      attrs, R, tile_ids, tile_start, tile_stop, soff, kexit, stash,        \
      stash_rows, dstate0, tiles_x, d_attrs)
    if (use_sa) {
      if (need_normal) GS_LAUNCH(true, true); else GS_LAUNCH(true, false);
    } else {
      if (need_normal) GS_LAUNCH(false, true); else GS_LAUNCH(false, false);
    }
#undef GS_LAUNCH
  }
  return (int)cudaGetLastError();
}

extern "C" int raster_backward_restash(const float* attrs, int R,
                                       const int* tile_start,
                                       const int* tile_stop, const int* soff,
                                       float* stash, int stash_rows,
                                       const float* dstate0, int n_tiles,
                                       int tiles_x, int use_sa,
                                       int need_normal, float* d_attrs,
                                       cudaStream_t stream) {
  if (n_tiles > 0) {
    dim3 grid(n_tiles);
#define GS_LAUNCH(SA, N)                                                    \
  raster_backward_restash_kernel<SA, N><<<grid, P, 0, stream>>>(            \
      attrs, R, tile_start, tile_stop, soff, stash, stash_rows, dstate0,    \
      tiles_x, d_attrs)
    if (use_sa) {
      if (need_normal) GS_LAUNCH(true, true); else GS_LAUNCH(true, false);
    } else {
      if (need_normal) GS_LAUNCH(false, true); else GS_LAUNCH(false, false);
    }
#undef GS_LAUNCH
  }
  return (int)cudaGetLastError();
}
