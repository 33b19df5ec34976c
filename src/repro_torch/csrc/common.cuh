// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel library is a plain C shared object loaded with ctypes
// (src/repro_torch/kernels/native.py): the launch functions take raw device
// pointers and a cudaStream_t passed as void*, launch on that stream and
// return cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro {

// dtype codes shared with native.py (DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

// masked-score value of the reference kernels (flash_attention.py:28,
// decode_attention.py:26): a large finite negative, not -inf, so a row
// whose every score is masked still normalises to finite weights
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }

// the one rounding of an fp32 result to the storage dtype (round to nearest even)
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current device:
// above 48 KB a kernel must ask first (cudaFuncSetAttribute). Each kernel
// instance passes its own `done` flags, so the attribute is set once per
// instance and device, before the instance's first launch there.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel* kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  done[dev] = true;
  return cudaSuccess;
}

}  // namespace repro

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
