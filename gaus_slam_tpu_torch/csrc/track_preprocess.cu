// K7 and K8: the tracking render's per-pair preprocess and its backward
// down to the pose gradient.
//
// No Pallas kernel is replaced. In the JAX package the tracking step's
// preprocess (gaus_slam_tpu/render/__init__.py::render_tracking: the pair
// cache moved by the live pose, then ops/preprocess.py::preprocess_t with
// an identity camera) is plain JAX that XLA fuses into a few loops. In
// PyTorch the same chain is some 320 elementwise kernels forward and 190
// backward, each streaming a row of R floats; inside a tracking
// iteration they cost about as much as K1 and K2 together. These two
// kernels do that work in one pass each
// (ops/track_preprocess.py::track_preprocess is the autograd.Function).
//
// K7 (track_preprocess_kernel): one thread per pair row. It reads the
// cache's 13 rows (xyz, scales, quats, opacity, rgb; a row stride of its
// own, so a head slice of the cache is read where it lies), the composed
// world-to-camera pose w2c [4, 4], the detached pose quaternion q [4] and
// the camera's pixel map M [3, 4] from device memory (the pose changes
// every iteration of a captured loop, so nothing of it is a launch
// argument), and writes the [PAIR_C = 24, R] pair attributes once. Its
// arithmetic is the chain's, operation for operation and in the chain's
// order (-fmad=false: no contraction), so it gives the chain's bits where
// the chain's inputs are the same; only xyz_cam = R xyz + t is a matrix
// product in the chain (a cuBLAS one on the card), computed here as
// ((r0 x + r1 y) + r2 z) + t.
//
// K8 (track_pose_grad_kernel + track_pose_grad_finish): only a0, a1, a2
// and tw carry gradient (the centre, the normal and the rotated
// quaternions are detached, the map frozen), and of those only through
// hp = M [xyz_cam, 1], the third component of tu, tv and tw. So per pair
//   d_hp = ((d_a1 x tw)_z + (tv x d_a2)_z, (tw x d_a0)_z + (d_a2 x tu)_z,
//           d_tw_z + (tu x d_a1)_z + (d_a0 x tv)_z),
// which reads rows 0, 1, 3, 4, 6, 7 and 11 of d_attrs and the x, y
// components of tu, tv, tw (M times the rotated, scaled axes, recomputed
// from the cache's scales and quats and q as K7 computes them), then
// d_xyz_cam = M[:, :3]^T d_hp, and d_w2c[j, k] = sum over pairs of
// d_xyz_cam_j [xyz, 1]_k, the 12 entries of the top three rows (the
// bottom row gets 0). The sum is deterministic: each block reduces its
// rows in a fixed order into its own 12 partials (a buffer the wrapper
// allocates), and one block then sums the partials in block order. No
// atomics.
//
// What bounds them: device memory bytes. K7 reads 13 and writes 24
// floats a pair (148 bytes; 155 MB at R = 2^20, 46 us at 3.35 TB/s), K8
// reads 16 (64 bytes). Loads and stores are one float a thread, adjacent
// threads on adjacent pairs, so every row streams coalesced.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int PAIR_C = 24;
constexpr int GRAD_C = 12;        // d_w2c's top three rows
constexpr int MAX_BLOCKS = 1024;  // K8's first pass
constexpr float C2 = 9.0f;        // CUTOFF * CUTOFF

struct Axes {
  float hu[3], hv[3];  // M[:, :3] L0, M[:, :3] L1 (tu, tv, tw's x and y)
  float nw[3];         // the rotated normal axis (the third column of R)
};

// q (x) quat, as se3.quat_multiply_rows computes it, then preprocess_t's
// rotation, the scaled axes and their pixel-space images.
__device__ __forceinline__ Axes axes(const float* __restrict__ q,
                                     const float* __restrict__ M, float w2,
                                     float x2, float y2, float z2, float s0,
                                     float s1) {
  const float w1 = q[0], x1 = q[1], y1 = q[2], z1 = q[3];
  const float qw = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
  const float qx = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  const float qy = w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2;
  const float qz = w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2;
  float n2 = qw * qw + qx * qx + qy * qy + qz * qz;
  n2 = n2 < 1e-24f ? 1e-24f : n2;  // clamp(min=1e-24), NaN passes
  const float s = (1.0f / n2) * 2.0f;
  const float r00 = 1.0f - s * (qy * qy + qz * qz);
  const float r01 = s * (qx * qy - qw * qz);
  const float r02 = s * (qx * qz + qw * qy);
  const float r10 = s * (qx * qy + qw * qz);
  const float r11 = 1.0f - s * (qx * qx + qz * qz);
  const float r12 = s * (qy * qz - qw * qx);
  const float r20 = s * (qx * qz - qw * qy);
  const float r21 = s * (qy * qz + qw * qx);
  const float r22 = 1.0f - s * (qx * qx + qy * qy);
  const float l0[3] = {r00 * s0, r10 * s0, r20 * s0};
  const float l1[3] = {r01 * s1, r11 * s1, r21 * s1};
  Axes a;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* m = M + 4 * i;
    a.hu[i] = m[0] * l0[0] + m[1] * l0[1] + m[2] * l0[2];
    a.hv[i] = m[0] * l1[0] + m[1] * l1[1] + m[2] * l1[2];
  }
  a.nw[0] = r02;
  a.nw[1] = r12;
  a.nw[2] = r22;
  return a;
}

__global__ void __launch_bounds__(THREADS) track_preprocess_kernel(
    const float* __restrict__ raw, int64_t ld, int n,
    const float* __restrict__ w2c, const float* __restrict__ q,
    const float* __restrict__ M, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float* p = raw + i;
  const float x = __ldg(p), y = __ldg(p + ld), z = __ldg(p + 2 * ld);
  const Axes a = axes(q, M, __ldg(p + 5 * ld), __ldg(p + 6 * ld),
                      __ldg(p + 7 * ld), __ldg(p + 8 * ld),
                      __ldg(p + 3 * ld), __ldg(p + 4 * ld));
  float xc[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* w = w2c + 4 * r;
    xc[r] = w[0] * x + w[1] * y + w[2] * z + w[3];
  }
  // the camera of the chain's preprocess is the identity: pv = I xc, and
  // the normal I nw, each as mat_rows multiplies it
  float pv[3], nc[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float e0 = r == 0 ? 1.0f : 0.0f, e1 = r == 1 ? 1.0f : 0.0f,
                e2 = r == 2 ? 1.0f : 0.0f;
    pv[r] = e0 * xc[0] + e1 * xc[1] + e2 * xc[2] + 0.0f;
    nc[r] = e0 * a.nw[0] + e1 * a.nw[1] + e2 * a.nw[2];
  }
  float hp[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* m = M + 4 * r;
    hp[r] = m[0] * xc[0] + m[1] * xc[1] + m[2] * xc[2] + m[3];
  }
  const float tu[3] = {a.hu[0], a.hv[0], hp[0]};
  const float tv[3] = {a.hu[1], a.hv[1], hp[1]};
  const float tw[3] = {a.hu[2], a.hv[2], hp[2]};
  float v[PAIR_C];
  // a0 = tv x tw, a1 = tw x tu, a2 = tu x tv
  v[0] = tv[1] * tw[2] - tv[2] * tw[1];
  v[1] = tv[2] * tw[0] - tv[0] * tw[2];
  v[2] = tv[0] * tw[1] - tv[1] * tw[0];
  v[3] = tw[1] * tu[2] - tw[2] * tu[1];
  v[4] = tw[2] * tu[0] - tw[0] * tu[2];
  v[5] = tw[0] * tu[1] - tw[1] * tu[0];
  v[6] = tu[1] * tv[2] - tu[2] * tv[1];
  v[7] = tu[2] * tv[0] - tu[0] * tv[2];
  v[8] = tu[0] * tv[1] - tu[1] * tv[0];
  v[9] = tw[0];
  v[10] = tw[1];
  v[11] = tw[2];
  const float cosv = -(pv[0] * nc[0] + pv[1] * nc[1] + pv[2] * nc[2]);
  const float flip = cosv > 0.0f ? 1.0f : -1.0f;
  const float dist = C2 * (tw[0] * tw[0] + tw[1] * tw[1]) - tw[2] * tw[2];
  const bool valid = pv[2] > 0.2f && cosv != 0.0f && dist != 0.0f;
  const float inv_d = (1.0f / (dist == 0.0f ? 1.0f : dist)) * 1.0f;
  v[12] = (C2 * (tu[0] * tw[0] + tu[1] * tw[1]) - tu[2] * tw[2]) * inv_d;
  v[13] = (C2 * (tv[0] * tw[0] + tv[1] * tw[1]) - tv[2] * tw[2]) * inv_d;
  v[14] = nc[0] * flip;
  v[15] = nc[1] * flip;
  v[16] = nc[2] * flip;
  v[17] = valid ? __ldg(p + 9 * ld) : 0.0f;
  v[18] = __ldg(p + 10 * ld);
  v[19] = __ldg(p + 11 * ld);
  v[20] = __ldg(p + 12 * ld);
  v[21] = 0.0f;
  v[22] = 0.0f;
  v[23] = 0.0f;
#pragma unroll
  for (int c = 0; c < PAIR_C; ++c) out[(int64_t)c * n + i] = v[c];
}

// The 12 partial sums of one thread: a fixed order over its rows.
__global__ void __launch_bounds__(THREADS) track_pose_grad_kernel(
    const float* __restrict__ raw, int64_t ld, int n,
    const float* __restrict__ q, const float* __restrict__ M,
    const float* __restrict__ d_attrs, int64_t ld_d,
    float* __restrict__ partials) {
  float acc[GRAD_C];
#pragma unroll
  for (int e = 0; e < GRAD_C; ++e) acc[e] = 0.0f;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const float* p = raw + i;
    const Axes a = axes(q, M, __ldg(p + 5 * ld), __ldg(p + 6 * ld),
                        __ldg(p + 7 * ld), __ldg(p + 8 * ld),
                        __ldg(p + 3 * ld), __ldg(p + 4 * ld));
    const float* g = d_attrs + i;
    const float g0x = __ldg(g), g0y = __ldg(g + ld_d);
    const float g1x = __ldg(g + 3 * ld_d), g1y = __ldg(g + 4 * ld_d);
    const float g2x = __ldg(g + 6 * ld_d), g2y = __ldg(g + 7 * ld_d);
    const float gtz = __ldg(g + 11 * ld_d);
    // tu = (hu0, hv0, .), tv = (hu1, hv1, .), tw = (hu2, hv2, .)
    const float d0 = (g1x * a.hv[2] - g1y * a.hu[2]) +
                     (a.hu[1] * g2y - a.hv[1] * g2x);
    const float d1 = (a.hu[2] * g0y - a.hv[2] * g0x) +
                     (g2x * a.hv[0] - g2y * a.hu[0]);
    const float d2 = gtz + (a.hu[0] * g1y - a.hv[0] * g1x) +
                     (g0x * a.hv[1] - g0y * a.hu[1]);
    const float xyz1[4] = {__ldg(p), __ldg(p + ld), __ldg(p + 2 * ld), 1.0f};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float dx = M[j] * d0 + M[4 + j] * d1 + M[8 + j] * d2;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[4 * j + k] += dx * xyz1[k];
    }
  }
  // the block's sum: warps by shuffles (a fixed tree), then the warps'
  // sums in warp order
  __shared__ float warp_sums[THREADS / 32][GRAD_C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < GRAD_C; ++e) {
    float v = acc[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][e] = v;
  }
  __syncthreads();
  if (threadIdx.x < GRAD_C) {
    float v = 0.0f;
    for (int w = 0; w < THREADS / 32; ++w) v += warp_sums[w][threadIdx.x];
    partials[(int64_t)blockIdx.x * GRAD_C + threadIdx.x] = v;
  }
}

// One block: entry e of d_w2c is warp e's sum over the blocks' partials
// (lane l takes blocks l, l + 32, ... in order, then a fixed tree).
__global__ void track_pose_grad_finish(const float* __restrict__ partials,
                                       int n_blocks,
                                       float* __restrict__ d_w2c) {
  const int lane = threadIdx.x & 31, e = threadIdx.x >> 5;
  if (e < GRAD_C) {
    float v = 0.0f;
    for (int b = lane; b < n_blocks; b += 32) v += partials[b * GRAD_C + e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) d_w2c[e] = v;
  } else if (e == GRAD_C && lane < 4) {
    d_w2c[GRAD_C + lane] = 0.0f;
  }
}

}  // namespace

extern "C" int track_preprocess_blocks(int n) {
  const int b = (n + THREADS - 1) / THREADS;
  return b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b);
}

extern "C" int track_preprocess(const float* raw, int64_t ld, int n,
                                const float* w2c, const float* q,
                                const float* M, float* out,
                                cudaStream_t stream) {
  if (n > 0)
    track_preprocess_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                              stream>>>(raw, ld, n, w2c, q, M, out);
  return (int)cudaGetLastError();
}

// partials: float [track_preprocess_blocks(n), 12]; d_w2c: float [4, 4].
extern "C" int track_preprocess_backward(const float* raw, int64_t ld, int n,
                                         const float* q, const float* M,
                                         const float* d_attrs, int64_t ld_d,
                                         float* partials, float* d_w2c,
                                         cudaStream_t stream) {
  const int blocks = track_preprocess_blocks(n);
  track_pose_grad_kernel<<<blocks, THREADS, 0, stream>>>(
      raw, ld, n, q, M, d_attrs, ld_d, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  track_pose_grad_finish<<<1, 32 * (GRAD_C + 1), 0, stream>>>(
      partials, blocks, d_w2c);
  return (int)cudaGetLastError();
}
