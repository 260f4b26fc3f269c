// K6: the f32 vs bf16 elementwise-rate probe, three dependent chains per
// element.
//
// Replaces the Pallas kernel tools/bf16_probe.py::build (bodies _kern_fma,
// _kern_exp, _kern_mixed), which asked whether the TPU's vector unit runs
// bf16 elementwise math at twice the f32 rate. The chains, per element x:
//   fma   n times  x = x * 1.0001 + 1e-4
//   exp   n times  x = exp(x * -0.5) + 1
//   mixed n times  x = x * 1.0001 + 1e-4, and after every 8th step
//                  x = exp(x * -0.25); x = x > 0.7 ? x * 1.0001 : x
// with every constant in the chain's dtype, as the JAX bodies write them.
//
// What bounds it on Hopper. At the probe's [4096, 512] shape each launch
// reads and writes the array once (16.8 MB in f32, 8.4 MB in bf16: 5.0 and
// 2.5 us at 3.35 TB/s; both fit the 50 MB L2), and the fma chain's 64
// dependent FMAs per element are 4.0 us at the f32 rate of 67 TFLOP/s, so
// the card is about as much bound by bytes as by operations there. The
// exp chain's 8 exp per element go to the special-function units (16
// results per SM per clock: 4.0 us). Both chains are dependent per
// element, so each thread carries several independent elements to hide
// the pipeline latency.
//
// Design. One thread per 16-byte vector: four f32 elements, or four
// __nv_bfloat162 pairs (eight bf16). bf16 runs packed: __hfma2, h2exp, a
// packed compare (__hgt2_mask) and a bitwise select. Packed bf16 is the
// form in which Hopper's CUDA cores can reach twice the f32 FMA rate
// (NVIDIA H100 Tensor Core GPU Architecture white paper: 133.8 TFLOP/s
// bf16 and 66.9 TFLOP/s f32 outside the tensor cores, SXM5); a scalar bf16
// chain is widened to f32 and would answer another question. The library
// builds with -fmad=false, so the f32 chain writes its FMA as fmaf and its
// multiplies and adds with explicit rounding; expf is the accurate
// libdevice exp, not __expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kFma = 0, kExp = 1, kMixed = 2;

struct F32 {
  using T = float;
  __device__ static T c(float v) { return v; }
  __device__ static T fma(T x, T a, T b) { return fmaf(x, a, b); }
  __device__ static T mul(T x, T a) { return __fmul_rn(x, a); }
  __device__ static T add(T x, T a) { return __fadd_rn(x, a); }
  __device__ static T exp(T x) { return expf(x); }
  // x > th ? xa : x
  __device__ static T select_gt(T x, T th, T xa) { return x > th ? xa : x; }
};

struct BF16x2 {
  using T = __nv_bfloat162;
  __device__ static T c(float v) { return __float2bfloat162_rn(v); }
  __device__ static T fma(T x, T a, T b) { return __hfma2(x, a, b); }
  __device__ static T mul(T x, T a) { return __hmul2(x, a); }
  __device__ static T add(T x, T a) { return __hadd2(x, a); }
  __device__ static T exp(T x) { return h2exp(x); }
  __device__ static T select_gt(T x, T th, T xa) {
    const unsigned m = __hgt2_mask(x, th);  // 0xffff per lane where x > th
    const unsigned r = (m & *reinterpret_cast<const unsigned*>(&xa)) |
                       (~m & *reinterpret_cast<const unsigned*>(&x));
    return *reinterpret_cast<const T*>(&r);
  }
};

template <class Op, int Chain>
__device__ __forceinline__ typename Op::T chain_step(typename Op::T x,
                                                     int step) {
  using T = typename Op::T;
  const T a = Op::c(1.0001f), b = Op::c(1e-4f);
  if (Chain == kExp) return Op::add(Op::exp(Op::mul(x, Op::c(-0.5f))),
                                    Op::c(1.0f));
  x = Op::fma(x, a, b);
  if (Chain == kMixed && (step & 7) == 7) {
    x = Op::exp(Op::mul(x, Op::c(-0.25f)));
    x = Op::select_gt(x, Op::c(0.7f), Op::mul(x, a));
  }
  return x;
}

// Each thread owns one 16-byte vector: kLanes values of Op::T.
template <class Op, int Chain>
__global__ void probe_kernel(const uint4* __restrict__ in,
                             uint4* __restrict__ out, int64_t n_vec, int n) {
  using T = typename Op::T;
  constexpr int kLanes = 16 / sizeof(T);
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_vec) return;
  uint4 v = in[i];
  T x[kLanes];
  memcpy(x, &v, 16);
  // groups of 8 steps, unrolled, so the mixed chain's every-8th-step test
  // is resolved at compile time
  for (int s0 = 0; s0 < n; s0 += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (s0 + j < n) {
#pragma unroll
        for (int l = 0; l < kLanes; ++l) x[l] = chain_step<Op, Chain>(x[l], j);
      }
    }
  }
  memcpy(&v, x, 16);
  out[i] = v;
}

template <class Op>
int launch(int chain, const void* in, void* out, int64_t n_vec, int n,
           cudaStream_t stream) {
  if (n_vec <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned blocks = (unsigned)((n_vec + threads - 1) / threads);
  const uint4* src = static_cast<const uint4*>(in);
  uint4* dst = static_cast<uint4*>(out);
  if (chain == kFma)
    probe_kernel<Op, kFma><<<blocks, threads, 0, stream>>>(src, dst, n_vec, n);
  else if (chain == kExp)
    probe_kernel<Op, kExp><<<blocks, threads, 0, stream>>>(src, dst, n_vec, n);
  else if (chain == kMixed)
    probe_kernel<Op, kMixed><<<blocks, threads, 0, stream>>>(src, dst, n_vec,
                                                             n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// chain: 0 fma, 1 exp, 2 mixed; bf16: 0 = float32 elements, 1 = bfloat16.
// n_elem must be a multiple of 16 / sizeof(element) and both pointers
// 16-byte aligned (the wrapper checks both).
extern "C" int bf16_probe(const void* in, void* out, int64_t n_elem, int chain,
                          int n, int bf16, cudaStream_t stream) {
  if (bf16) return launch<BF16x2>(chain, in, out, n_elem / 8, n, stream);
  return launch<F32>(chain, in, out, n_elem / 4, n, stream);
}
