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
// Design. The unit of work is a 16-byte vector: four f32 elements, or four
// __nv_bfloat162 pairs (eight bf16). bf16 runs packed: __hfma2, h2exp, a
// packed compare (__hgt2_mask) and a bitwise select. Packed bf16 is the
// form in which Hopper's CUDA cores can reach twice the f32 FMA rate
// (NVIDIA H100 Tensor Core GPU Architecture white paper: 133.8 TFLOP/s
// bf16 and 66.9 TFLOP/s f32 outside the tensor cores, SXM5); a scalar bf16
// chain is widened to f32 and would answer another question. The library
// builds with -fmad=false, so the f32 chain writes its FMA as fmaf and its
// multiplies and adds with explicit rounding; expf is the accurate
// libdevice exp, not __expf.
//
// Each thread owns V vectors, V * 16 / sizeof(T) independent chains: it
// issues all V loads before the first chain step, so V loads are in
// flight per thread and the chains interleave in the pipeline, then stores
// the V vectors. The grid is sized to the card: V is the smallest of 1, 2
// and 4 that needs at most ctas_per_sm CTAs of 256 threads per SM, so the
// whole array is one wave of CTAs; beyond V = 4 the kernel strides over
// the array. The fma and mixed chains take 4 CTAs per SM, half the SM's
// 2048 threads with more chains per thread; the exp chain, which waits on
// the special-function units, takes 8, every warp the SM holds. On an
// H100 (tools/bf16_probe.py --old: V = 1, 2, 4 at 4 CTAs per SM against
// one vector per thread in 1.94 waves) half occupancy was fastest for the
// fma and mixed chains, and for the bf16 exp chain the old full grid.
// The chain per element is the same for every V, so every V gives the
// same bits.
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

// Each thread owns V 16-byte vectors, kLanes values of Op::T each: vector
// k of a thread at base + k * blockDim.x, so each of the V loads of a warp
// is one coalesced 512-byte transaction.
template <class Op, int Chain, int V>
__global__ void __launch_bounds__(256)
    probe_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                 int64_t n_vec, int n) {
  using T = typename Op::T;
  constexpr int kLanes = 16 / sizeof(T);
  const int64_t step = (int64_t)gridDim.x * blockDim.x * V;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x * V + threadIdx.x;
       base < n_vec; base += step) {
    uint4 v[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int64_t i = base + (int64_t)k * blockDim.x;
      v[k] = i < n_vec ? __ldg(in + i) : make_uint4(0, 0, 0, 0);
    }
    T x[V * kLanes];
    memcpy(x, v, sizeof(v));
    // groups of 8 steps, unrolled, so the mixed chain's every-8th-step
    // test is resolved at compile time
    for (int s0 = 0; s0 < n; s0 += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (s0 + j < n) {
#pragma unroll
          for (int l = 0; l < V * kLanes; ++l)
            x[l] = chain_step<Op, Chain>(x[l], j);
        }
      }
    }
    memcpy(v, x, sizeof(v));
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int64_t i = base + (int64_t)k * blockDim.x;
      if (i < n_vec) out[i] = v[k];
    }
  }
}

constexpr int kThreads = 256;

template <int Chain>
constexpr int ctas_per_sm() {
  return Chain == kExp ? 8 : 4;
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

template <class Op, int Chain, int V>
void launch_v(const uint4* src, uint4* dst, int64_t n_vec, int n,
              cudaStream_t stream) {
  const int64_t per_cta = (int64_t)kThreads * V;
  int64_t blocks = (n_vec + per_cta - 1) / per_cta;
  const int64_t wave = (int64_t)ctas_per_sm<Chain>() * num_sms();
  if (blocks > wave) blocks = wave;  // the rest by striding
  probe_kernel<Op, Chain, V>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(src, dst, n_vec, n);
}

// vpt: vectors per thread (1, 2 or 4), or 0 for the smallest with which
// ctas_per_sm CTAs per SM cover the array.
template <class Op, int Chain>
void launch_chain(const uint4* src, uint4* dst, int64_t n_vec, int n, int vpt,
                  cudaStream_t stream) {
  if (vpt == 0) {
    const int64_t wave = (int64_t)ctas_per_sm<Chain>() * num_sms() * kThreads;
    vpt = n_vec <= wave ? 1 : n_vec <= 2 * wave ? 2 : 4;
  }
  if (vpt == 1)
    launch_v<Op, Chain, 1>(src, dst, n_vec, n, stream);
  else if (vpt == 2)
    launch_v<Op, Chain, 2>(src, dst, n_vec, n, stream);
  else
    launch_v<Op, Chain, 4>(src, dst, n_vec, n, stream);
}

template <class Op>
int launch(int chain, const void* in, void* out, int64_t n_vec, int n, int vpt,
           cudaStream_t stream) {
  if (n_vec <= 0) return (int)cudaGetLastError();
  if (vpt != 0 && vpt != 1 && vpt != 2 && vpt != 4)
    return (int)cudaErrorInvalidValue;
  const uint4* src = static_cast<const uint4*>(in);
  uint4* dst = static_cast<uint4*>(out);
  if (chain == kFma)
    launch_chain<Op, kFma>(src, dst, n_vec, n, vpt, stream);
  else if (chain == kExp)
    launch_chain<Op, kExp>(src, dst, n_vec, n, vpt, stream);
  else if (chain == kMixed)
    launch_chain<Op, kMixed>(src, dst, n_vec, n, vpt, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// chain: 0 fma, 1 exp, 2 mixed; bf16: 0 = float32 elements, 1 = bfloat16;
// vpt: vectors per thread (0 = sized to the card, or 1, 2, 4; every value
// gives the same bits). n_elem must be a multiple of 16 / sizeof(element)
// and both pointers 16-byte aligned (the wrapper checks both).
extern "C" int bf16_probe(const void* in, void* out, int64_t n_elem, int chain,
                          int n, int bf16, int vpt, cudaStream_t stream) {
  if (bf16) return launch<BF16x2>(chain, in, out, n_elem / 8, n, vpt, stream);
  return launch<F32>(chain, in, out, n_elem / 4, n, vpt, stream);
}
