// act_lut: the 33-knot piecewise-linear activation over a whole tensor.
//
// Replaces the Pallas TPU kernel `act_lut`
// (src/repro/kernels/act_lut/act_lut.py:58, body `lut_eval` at :27). The TPU
// kernel tiles the flattened tensor into (8, 1024) blocks and picks each
// segment's slope and intercept with a select tree (no gather from VMEM). Here
// the 99 table floats are staged once per block in shared memory and the ends
// (first and last knot, both clamps) held in registers; each thread of a
// grid-stride loop loads kUnroll 16-byte vectors of x (8 bf16/fp16 or 4 fp32
// values) before it evaluates any, widens 16-bit values in packed pairs, runs
// the shared lut_eval (lut_eval.cuh: a five-step search over the knots, 7
// shared-memory reads an element, conflict-free since a warp's reads of one
// step fall on distinct words of one 32-word run) and narrows in pairs to one
// 16-byte store in x's dtype; a scalar loop takes the tail and unaligned
// tensors.
//
// What bounds it on an H100: device-memory bytes, 2 * itemsize per element
// (x read once, y written once) at 3.35 TB/s; the five compares, the
// multiply-add and the clamps are ~20 operations an element, below the fp32
// rate for every dtype the kernel takes, and the 7 shared-memory reads an
// element (one warp-wide read a cycle per SM) stay under the bytes time at
// 16-bit widths.
#include <type_traits>

#include "lut_eval.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kUnroll = 2;      // 16-byte vectors a thread has in flight

struct Ends {
  float x0, x32, lo, hi;
};

template <bool ANE>
__device__ __forceinline__ float eval(float x, const float* tab, const Ends& e) {
  return lut_eval(x, tab, tab + 33, tab + 65, e.x0, e.x32, e.lo, e.hi, ANE);
}

// one 16-byte vector of T through the table; 16-bit values widen and narrow
// in pairs (exact widening, one round-to-nearest-even narrowing, the same
// bits as one at a time)
template <typename T, bool ANE>
__device__ __forceinline__ uint4 eval_vec(uint4 raw, const float* tab, const Ends& e) {
  uint4 out;
  if constexpr (sizeof(T) == 4) {
    const float* in = reinterpret_cast<const float*>(&raw);
    float* o = reinterpret_cast<float*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = eval<ANE>(in[j], tab, e);
  } else {
    using T2 = typename std::conditional<std::is_same<T, __half>::value, __half2,
                                         __nv_bfloat162>::type;
    const T2* in = reinterpret_cast<const T2*>(&raw);
    T2* o = reinterpret_cast<T2*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f;
      if constexpr (std::is_same<T, __half>::value) f = __half22float2(in[j]);
      else f = __bfloat1622float2(in[j]);
      const float a = eval<ANE>(f.x, tab, e), b = eval<ANE>(f.y, tab, e);
      if constexpr (std::is_same<T, __half>::value) o[j] = __floats2half2_rn(a, b);
      else o[j] = __floats2bfloat162_rn(a, b);
    }
  }
  return out;
}

template <typename T, bool ANE>
__global__ void __launch_bounds__(kThreads)
    act_lut_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ table,
                   long long n, long long nvec) {
  __shared__ float tab[kLutFloats];
  for (int i = threadIdx.x; i < kLutFloats; i += kThreads) tab[i] = table[i];
  __syncthreads();
  const Ends e{tab[0], tab[32], tab[97], tab[98]};
  constexpr int V = 16 / sizeof(T);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads * kUnroll;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
  for (long long v0 = first; v0 < nvec; v0 += stride) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * kThreads;
      if (v < nvec) raw[u] = __ldg(xv + v);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * kThreads;
      if (v < nvec) yv[v] = eval_vec<T, ANE>(raw[u], tab, e);
    }
  }
  const long long tail = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long tail_stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = nvec * V + tail; i < n; i += tail_stride)
    y[i] = from_f32<T>(eval<ANE>(to_f32<T>(x[i]), tab, e));
}

template <typename T>
int run(const void* x, void* y, const void* table, long long n, int ane, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15u) == 0;
  const long long nvec = aligned ? n / V : 0;
  const long long per_block = nvec > 0 ? static_cast<long long>(kThreads) * kUnroll : kThreads;
  const long long blocks = ((nvec > 0 ? nvec : n) + per_block - 1) / per_block;
  const int grid = static_cast<int>(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const float* tab = static_cast<const float*>(table);
  if (ane) act_lut_kernel<T, true><<<grid, kThreads, 0, s>>>(xt, yt, tab, n, nvec);
  else act_lut_kernel<T, false><<<grid, kThreads, 0, s>>>(xt, yt, tab, n, nvec);
  return cudaGetLastError();
}

}  // namespace

// x, y: n contiguous elements of one dtype (code); table: kLutFloats fp32
// with non-decreasing knots (checked on the host)
extern "C" int act_lut_launch(const void* x, void* y, const void* table, long long n, int dtype,
                              int ane_mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return run<float>(x, y, table, n, ane_mode, s);
  if (dtype == kBF16) return run<__nv_bfloat16>(x, y, table, n, ane_mode, s);
  if (dtype == kF16) return run<__half>(x, y, table, n, ane_mode, s);
  return cudaErrorInvalidValue;
}
