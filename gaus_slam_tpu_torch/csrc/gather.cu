// K4: monotone row gather in the row layout, out[i, :] = data[pos[i], :].
//
// Replaces the Pallas kernel gaus_slam_tpu/ops/gather.py::monotone_row_gather
// (banded DMA + one-hot MXU matmul). On the TPU a general row gather was
// latency-bound per row, so the JAX kernel turned it into a bandwidth
// problem, on the [C, R] layout the TPU's 128 lanes wanted. On Hopper a
// gather is a plain load, and the gradient reduction already holds its
// run totals as [R, C] rows (C = 24 floats, 96 contiguous bytes), so the
// kernel gathers whole rows there and nothing transposes around it.
//
// What bounds it: device memory bytes: the distinct rows pos names read
// once, N rows written, and pos. Design: a CTA takes ROWS output rows; its
// threads load the rows' positions once each into shared memory, then move
// the rows as 16-byte vectors (float4; six per row at C = 24), consecutive
// threads on consecutive vectors, so the loads of one source row and the
// stores of the output coalesce (monotone pos keeps a CTA's source rows in
// a narrow band). Where C is not a multiple of 4 or a row is not 16-byte
// aligned, the same loop moves single floats. A position outside [0, R)
// reads nothing and writes NaN. It only moves floats: bit-exact with
// data[pos].
#include <cuda_runtime.h>
#include <cstdint>

constexpr int ROWS = 256;  // output rows per CTA (= threads per CTA)

__device__ __forceinline__ float nan_of(float) {
  return __int_as_float(0x7fc00000);
}

__device__ __forceinline__ float4 nan_of(float4) {
  const float q = __int_as_float(0x7fc00000);
  return make_float4(q, q, q, q);
}

// V = float4 (W = C / 4 vectors per row) or float (W = C).
template <typename V>
__global__ void __launch_bounds__(ROWS) row_gather_kernel(
    const V* __restrict__ data, const int* __restrict__ pos,
    V* __restrict__ out, int n_rows_in, int n_rows_out, int W) {
  __shared__ int spos[ROWS];
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  const int nrows = (int)min((int64_t)ROWS, n_rows_out - row0);
  if ((int)threadIdx.x < nrows) spos[threadIdx.x] = __ldg(pos + row0 + threadIdx.x);
  __syncthreads();
  V* o = out + row0 * W;
  for (int e = threadIdx.x; e < nrows * W; e += ROWS) {
    const int r = e / W;
    const int src = spos[r];
    o[e] = (src >= 0 && src < n_rows_in)
               ? __ldg(data + (int64_t)src * W + (e - r * W))
               : nan_of(V());
  }
}

extern "C" int monotone_row_gather_rows(const float* data, const int* pos,
                                        float* out, int n_rows_in,
                                        int n_rows_out, int channels,
                                        cudaStream_t stream) {
  if (n_rows_out > 0 && channels > 0) {
    const dim3 grid((n_rows_out + ROWS - 1) / ROWS);
    const bool vec = channels % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (vec)
      row_gather_kernel<float4><<<grid, ROWS, 0, stream>>>(
          reinterpret_cast<const float4*>(data), pos,
          reinterpret_cast<float4*>(out), n_rows_in, n_rows_out,
          channels / 4);
    else
      row_gather_kernel<float><<<grid, ROWS, 0, stream>>>(
          data, pos, out, n_rows_in, n_rows_out, channels);
  }
  return (int)cudaGetLastError();
}
