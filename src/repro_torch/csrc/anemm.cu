// anemm: (M, K) x (K, N) with an fp32 accumulator and the ANE-mode epilogue.
//
// Replaces the Pallas TPU kernel `anemm` (src/repro/kernels/anemm/anemm.py:69,
// body `_kernel` at :32). The TPU kernel walks a sequential "arbitrary" K grid
// axis with the fp32 accumulator in VMEM scratch; here each block owns one
// output tile and loops over K itself, so nothing carries between blocks and
// no split-K is used: every output element is summed in the same K order
// whatever M is. Ragged edges are masked in the kernel (zero-filled shared
// tiles) instead of padding the operands in device memory as `pad_to` does.
// The epilogue runs in the reference's order: per-N scale, bias, ANE-mode
// saturation (|acc| >= 2^15 -> +-inf), then ONE rounding to the input dtype.
//
// What bounds it on an H100: the serving path calls it at two extremes. At
// decode (M = lanes, about 8) the weight matrix is read once and reused by
// only M rows, so the product is bound by device-memory bytes (3.35 TB/s);
// at prefill (M = prompt tokens) it is bound by tensor-core operations.
// This first version is simple: 16-bit inputs go through WMMA (mma.sync on
// tensor cores) from shared-memory tiles loaded with 16-byte vectors where
// aligned, fp32 inputs through true fp32 FMA (never TF32) with a 4x4 register
// micro-tile per thread. Neither pipelines its loads (no cp.async/TMA, no
// wgmma), so both sit well below their bound; that is later work.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr float kCeiling = 32768.0f;  // hal.ACCUM_OUT_CEILING (2^15)

// scale -> bias -> saturation; __fmul_rn/__fadd_rn keep the two steps
// separately rounded, as the reference computes them (no FMA contraction)
__device__ __forceinline__ float epilogue(float acc, const float* scale, const float* bias,
                                          int n, int ane_mode) {
  if (scale != nullptr) acc = __fmul_rn(acc, scale[n]);
  if (bias != nullptr) acc = __fadd_rn(acc, bias[n]);
  if (ane_mode) {
    if (acc >= kCeiling) acc = INFINITY;
    if (acc <= -kCeiling) acc = -INFINITY;
  }
  return acc;
}

// ---------------------------------------------------------------------------
// fp32: SIMT FMA, 64x64 output tile, 256 threads of 4x4 outputs each
// ---------------------------------------------------------------------------

constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS)
    anemm_f32(const float* __restrict__ A, const float* __restrict__ B,
              const float* __restrict__ scale, const float* __restrict__ bias,
              float* __restrict__ C, int M, int N, int K, int ane_mode) {
  __shared__ float As[F_BK][F_BM + 4];  // A tile stored k-major
  __shared__ float Bs[F_BK][F_BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * F_BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += F_BK) {
    for (int i = tid; i < F_BM * F_BK; i += F_THREADS) {
      const int r = i / F_BK, c = i % F_BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.0f;
    }
    for (int i = tid; i < F_BK * F_BN; i += F_THREADS) {
      const int r = i / F_BN, c = i % F_BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) C[(size_t)gm * N + gn] = epilogue(acc[i][j], scale, bias, gn, ane_mode);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16: WMMA 16x16x16 with fp32 accumulators, 64x64 output tile,
// 4 warps of 32x32 each
// ---------------------------------------------------------------------------

constexpr int H_BM = 64, H_BN = 64, H_BK = 64, H_THREADS = 128;
constexpr int H_LDA = H_BK + 8;  // 144-byte rows: 16-byte aligned, banks skewed
constexpr int H_LDB = H_BN + 8;
constexpr int H_LDC = H_BN + 4;
constexpr int H_VEC = 8;  // 16-bit elements per 16-byte load

// rows x cols tile of a row-major (R x Cn, leading dim ld) matrix at
// (r0, c0) into shared memory, zero-filled outside the matrix
template <typename T, int ROWS, int COLS, int LDD>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, const T* __restrict__ src, int ld,
                                          int R, int Cn, int r0, int c0, bool vec_ok) {
  constexpr int CPR = COLS / H_VEC;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += H_THREADS) {
    const int r = i / CPR, c = (i % CPR) * H_VEC;
    const int gr = r0 + r, gc = c0 + c;
    T* d = dst + r * LDD + c;
    if (vec_ok && gr < R && gc + H_VEC <= Cn) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src + (size_t)gr * ld + gc);
    } else {
#pragma unroll
      for (int e = 0; e < H_VEC; ++e)
        d[e] = (gr < R && gc + e < Cn) ? src[(size_t)gr * ld + gc + e] : from_f32<T>(0.0f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(H_THREADS)
    anemm_mma(const T* __restrict__ A, const T* __restrict__ B, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ C, int M, int N, int K,
              int ane_mode, int vec_a, int vec_b) {
  using namespace nvcuda;
  __shared__ __align__(128) T As[H_BM * H_LDA];
  __shared__ __align__(128) T Bs[H_BK * H_LDB];
  __shared__ __align__(128) float Cs[H_BM * H_LDC];
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * H_BM, n0 = blockIdx.x * H_BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += H_BK) {
    load_tile<T, H_BM, H_BK, H_LDA>(As, A, K, M, K, m0, k0, vec_a);
    load_tile<T, H_BK, H_BN, H_LDB>(Bs, B, N, K, N, k0, n0, vec_b);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < H_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * H_LDA + kk, H_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Bs + kk * H_LDB + wn + 16 * j, H_LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * H_LDC + wn + 16 * j, acc[i][j], H_LDC,
                              wmma::mem_row_major);
  __syncthreads();
  const int rows = min(H_BM, M - m0);
  for (int i = threadIdx.x; i < rows * H_BN; i += H_THREADS) {
    const int r = i / H_BN, c = i % H_BN;
    const int gn = n0 + c;
    if (gn < N)
      C[(size_t)(m0 + r) * N + gn] = from_f32<T>(epilogue(Cs[r * H_LDC + c], scale, bias, gn, ane_mode));
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// a (M, K), b (K, N), out (M, N): row-major, contiguous, one dtype.
// scale/bias: (N,) fp32 or null.
extern "C" int anemm_launch(const void* a, const void* b, const void* scale, const void* bias,
                            void* out, int M, int N, int K, int dtype, int ane_mode,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == kF32) {
    dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM);
    anemm_f32<<<grid, F_THREADS, 0, s>>>(static_cast<const float*>(a), static_cast<const float*>(b),
                                         sc, bi, static_cast<float*>(out), M, N, K, ane_mode);
    return cudaGetLastError();
  }
  const int vec_a = (K % H_VEC == 0) && aligned16(a);
  const int vec_b = (N % H_VEC == 0) && aligned16(b);
  dim3 grid((N + H_BN - 1) / H_BN, (M + H_BM - 1) / H_BM);
  if (dtype == kBF16) {
    anemm_mma<__nv_bfloat16><<<grid, H_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), sc, bi,
        static_cast<__nv_bfloat16*>(out), M, N, K, ane_mode, vec_a, vec_b);
  } else if (dtype == kF16) {
    anemm_mma<__half><<<grid, H_THREADS, 0, s>>>(static_cast<const __half*>(a),
                                                 static_cast<const __half*>(b), sc, bi,
                                                 static_cast<__half*>(out), M, N, K, ane_mode,
                                                 vec_a, vec_b);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
