// K4: monotone row gather, out[c, i] = data[c, pos[i]].
//
// Replaces the Pallas kernel gaus_slam_tpu/ops/gather.py::monotone_row_gather
// (banded DMA + one-hot MXU matmul). On the TPU a general row gather was
// latency-bound per row, so the JAX kernel turned it into a bandwidth
// problem. On Hopper a gather is a plain load: every output element is
// one 4-byte read and one 4-byte write, so the kernel is bound by device
// memory bytes (C*N*4 written + C*N*4 read, the reads mostly coalesced
// because pos is monotone with steps <= max_step). Design: one thread per
// (channel, output column), consecutive threads on consecutive columns,
// so both the pos read and the output store coalesce; monotone pos keeps
// a warp's data reads inside a band of 32*max_step floats of one row.
// It only moves floats, so it is bit-exact with data_t[:, pos].
#include <cuda_runtime.h>
#include <cstdint>

__global__ void monotone_row_gather_kernel(const float* __restrict__ data,
                                           const int* __restrict__ pos,
                                           float* __restrict__ out,
                                           int n_cols_in, int n_cols_out,
                                           int channels) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (i >= n_cols_out || c >= channels) return;
  const int src = __ldg(pos + i);
  // a position outside [0, n_cols_in) reads nothing and yields NaN
  out[(int64_t)c * n_cols_out + i] =
      (src >= 0 && src < n_cols_in)
          ? __ldg(data + (int64_t)c * n_cols_in + src)
          : __int_as_float(0x7fc00000);
}

extern "C" int monotone_row_gather(const float* data, const int* pos,
                                   float* out, int n_cols_in, int n_cols_out,
                                   int channels, cudaStream_t stream) {
  if (n_cols_out > 0 && channels > 0) {
    dim3 block(256);
    dim3 grid((n_cols_out + 255) / 256, channels);
    monotone_row_gather_kernel<<<grid, block, 0, stream>>>(
        data, pos, out, n_cols_in, n_cols_out, channels);
  }
  return (int)cudaGetLastError();
}
