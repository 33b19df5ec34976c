// The tile loop of the port's matmuls: A (M, K) x B (K, N) -> (M, N) with an
// fp32 accumulator, shared by anemm (dense A and B), palette_matmul and
// sparse_matmul (B packed in device memory, decoded in the loop) and conv2d
// (A gathered from an NHWC image: an implicit GEMM). Each block owns one
// output tile and loops over K itself (no split-K, so an output element's sum
// order does not depend on M). 16-bit activations go through WMMA with fp32
// fragments, fp32 activations through true fp32 FMA (never TF32). Ragged
// edges are masked in the tile loads: both producers write zero outside the
// matrix, so nothing is padded in device memory.
//
// An A-tile producer AP provides
//   template <int ROWS, int COLS, int LDA, int THREADS>
//   __device__ void load(T* dst, int m0, int k0) const;      (16-bit loop)
//     write the ROWS x COLS tile of A at (m0, k0) into dst (leading
//     dimension LDA), zero outside the matrix; k0 is a multiple of 64;
//   __device__ float at(int m, int k) const;                  (fp32 loop)
//     one element of A, zero outside the matrix.
// DenseA below reads a row-major matrix.
//
// A B-tile producer P provides
//   struct Smem;                                  its shared-memory state
//   __device__ void prepare(Smem&) const;         fill it (all threads)
//   template <typename T, int ROWS, int COLS, int LDB, int THREADS>
//   __device__ void load(T* dst, const Smem&, int k0, int n0) const;
//     write the dense ROWS x COLS tile of B at (k0, n0) into dst (leading
//     dimension LDB), already in the activation's dtype T, zero outside the
//     matrix; k0 is a multiple of 16.
// An epilogue E provides
//   __device__ float operator()(float acc, int n) const;
//     the fp32 value stored (rounded once to T) for output column n.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace repro {
namespace tile {

// fp32: 64x64 output tile, 256 threads of 4x4 outputs, K steps of 16
constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_THREADS = 256;
constexpr int F_LDB = F_BN + 4;
// 16-bit: 64x64 output tile, 4 warps of 32x32 WMMA, K steps of 64
constexpr int H_BM = 64, H_BN = 64, H_BK = 64, H_THREADS = 128;
constexpr int H_LDA = H_BK + 8;  // 144-byte rows: 16-byte aligned, banks skewed
constexpr int H_LDB = H_BN + 8;
constexpr int H_LDC = H_BN + 4;
constexpr int H_VEC = 8;  // 16-bit elements per 16-byte load

// the stored value is the accumulator itself
struct Identity {
  __device__ float operator()(float acc, int) const { return acc; }
};

// ROWS x COLS tile of a row-major (R x Cn, leading dim ld) 16-bit matrix at
// (r0, c0) into shared memory, zero-filled outside the matrix; 16-byte
// vectors where `vec_ok`
template <typename T, int ROWS, int COLS, int LDD, int THREADS>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, const T* __restrict__ src, int ld,
                                          int R, int Cn, int r0, int c0, bool vec_ok) {
  constexpr int CPR = COLS / H_VEC;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
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

// A as a dense row-major (M, K) matrix in the activation's dtype
template <typename T>
struct DenseA {
  const T* __restrict__ a;
  int M, K;
  int vec;  // K % 8 == 0 and a 16-byte aligned

  template <int ROWS, int COLS, int LDA, int THREADS>
  __device__ __forceinline__ void load(T* __restrict__ dst, int m0, int k0) const {
    load_tile<T, ROWS, COLS, LDA, THREADS>(dst, a, K, M, K, m0, k0, vec);
  }
  __device__ __forceinline__ float at(int m, int k) const {
    return (m < M && k < K) ? a[(size_t)m * K + k] : 0.0f;
  }
};

template <typename T>
DenseA<T> dense_a(const void* a, int M, int K) {
  return {static_cast<const T*>(a), M, K,
          (K % H_VEC == 0) && (reinterpret_cast<uintptr_t>(a) & 15u) == 0};
}

// B as a dense row-major (K, N) matrix in the activation's dtype
template <typename T>
struct DenseB {
  const T* __restrict__ b;
  int K, N;
  int vec;  // N % 8 == 0 and b 16-byte aligned

  struct Smem {};

  __device__ void prepare(Smem&) const {}

  template <typename U, int ROWS, int COLS, int LDB, int THREADS>
  __device__ void load(U* __restrict__ dst, const Smem&, int k0, int n0) const {
    static_assert(std::is_same_v<T, U>, "dense B is stored in the activation's dtype");
    if constexpr (sizeof(T) == 2) {
      load_tile<T, ROWS, COLS, LDB, THREADS>(dst, b, N, K, N, k0, n0, vec);
    } else {
      for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
        const int r = i / COLS, c = i % COLS;
        const int gk = k0 + r, gn = n0 + c;
        dst[r * LDB + c] = (gk < K && gn < N) ? b[(size_t)gk * N + gn] : 0.0f;
      }
    }
  }
};

template <typename T>
DenseB<T> dense_b(const void* b, int K, int N) {
  return {static_cast<const T*>(b), K, N,
          (N % H_VEC == 0) && (reinterpret_cast<uintptr_t>(b) & 15u) == 0};
}

template <typename P>
__device__ __forceinline__ void prepare(const P& prod, typename P::Smem& ps) {
  if constexpr (!std::is_empty_v<typename P::Smem>) {
    prod.prepare(ps);
    __syncthreads();
  }
}

template <typename AP, typename P, typename E>
__global__ void __launch_bounds__(F_THREADS)
    matmul_f32(const AP ap, const P prod, const E epi, float* __restrict__ C, int M, int N,
               int K) {
  __shared__ float As[F_BK][F_BM + 4];  // A tile stored k-major
  __shared__ __align__(16) float Bs[F_BK * F_LDB];
  __shared__ typename P::Smem ps;
  prepare(prod, ps);
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
      As[c][r] = ap.at(m0 + r, k0 + c);
    }
    prod.template load<float, F_BK, F_BN, F_LDB, F_THREADS>(Bs, ps, k0, n0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * F_LDB + tx + 16 * j];
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
      if (gm < M && gn < N) C[(size_t)gm * N + gn] = epi(acc[i][j], gn);
    }
  }
}

// 6 blocks of 35 KB shared memory fill an SM; the register cap that
// __launch_bounds__ derives from it (80) keeps the 6 resident, so a 704-block
// grid (M=512 x N=5632) still runs in one wave on 132 SMs
constexpr int H_MIN_BLOCKS = 6;

template <typename T, typename AP, typename P, typename E>
__global__ void __launch_bounds__(H_THREADS, H_MIN_BLOCKS)
    matmul_mma(const AP ap, const P prod, const E epi, T* __restrict__ C, int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(128) T As[H_BM * H_LDA];
  __shared__ __align__(128) T Bs[H_BK * H_LDB];
  __shared__ __align__(128) float Cs[H_BM * H_LDC];
  __shared__ typename P::Smem ps;
  prepare(prod, ps);
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * H_BM, n0 = blockIdx.x * H_BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += H_BK) {
    ap.template load<H_BM, H_BK, H_LDA, H_THREADS>(As, m0, k0);
    prod.template load<T, H_BK, H_BN, H_LDB, H_THREADS>(Bs, ps, k0, n0);
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
    if (gn < N) C[(size_t)(m0 + r) * N + gn] = from_f32<T>(epi(Cs[r * H_LDC + c], gn));
  }
}

template <typename AP, typename P, typename E>
int launch_f32(const AP& ap, const P& prod, const E& epi, void* out, int M, int N, int K,
               cudaStream_t s) {
  dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM);
  matmul_f32<AP, P, E><<<grid, F_THREADS, 0, s>>>(ap, prod, epi, static_cast<float*>(out), M,
                                                  N, K);
  return cudaGetLastError();
}

template <typename T, typename AP, typename P, typename E>
int launch_mma(const AP& ap, const P& prod, const E& epi, void* out, int M, int N, int K,
               cudaStream_t s) {
  dim3 grid((N + H_BN - 1) / H_BN, (M + H_BM - 1) / H_BM);
  matmul_mma<T, AP, P, E><<<grid, H_THREADS, 0, s>>>(ap, prod, epi, static_cast<T*>(out), M,
                                                     N, K);
  return cudaGetLastError();
}

// Launch the loop with a dense A and no epilogue for an fp32 or bf16
// activation (dtype code) on `stream`; returns the launch's CUDA error.
template <typename P>
int launch(const P& prod, const void* a, void* out, int M, int N, int K, int dtype,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_f32(dense_a<float>(a, M, K), prod, Identity{}, out, M, N, K, s);
  if (dtype == kBF16)
    return launch_mma<__nv_bfloat16>(dense_a<__nv_bfloat16>(a, M, K), prod, Identity{}, out, M,
                                     N, K, s);
  return cudaErrorInvalidValue;
}

}  // namespace tile
}  // namespace repro
