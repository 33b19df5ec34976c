// The tile loops of the port's matmuls: A (M, K) x B (K, N) -> (M, N) with an
// fp32 accumulator and an epilogue functor, rounded once to the activation's
// dtype T. Two loops live here.
//
// The streaming loop (`matmul_stream`, namespace `stream`): every 16-bit
// product of the port. bf16 / fp16 anemm, bf16 sparse_matmul and
// palette_matmul (their weight producers in their own sources) and bf16 /
// fp16 conv2d (its activation producer gathers the implicit GEMM's rows).
// It replaces the TPU kernels' blocked products
// (src/repro/kernels/anemm/anemm.py:69, sparse/sparse_matmul.py:85,
// palette/palette_matmul.py:88, conv/conv2d.py:95), whose sequential K grid
// axis (or tap loop) carries `acc += dot(chunk)` in VMEM scratch.
//   * The weight's N is the MMA's 16-row side (Cᵀ = Bᵀ·Aᵀ): a block owns BN =
//     64 weight columns, 16 per warp, against BM = 8, 16, 32 or 64 activation
//     rows, the MMA's narrow side, so a decode step (M = 8) multiplies no
//     padded rows. mma.sync.m16n8k16 with fp32 accumulators, fed by the
//     weight producer's A fragments and by ldmatrix from the staged
//     activation rows.
//   * Each 64-deep K step's weight share (a dense tile, sparse_matmul's raw
//     values and selector bytes, palette_matmul's packed nibbles) and
//     activation slice stream through a four-stage ring of 16-byte cp.async
//     copies, the activation into 128-byte rows whose 16-byte chunks are
//     swizzled by row (conflict-free ldmatrix without padding). All four
//     stages are requested before the first MMA, and a slot is refilled as
//     soon as its step is consumed, so four steps are in flight while one
//     computes. A weight producer turns its staged share into the MMA's A
//     fragments (dense: one ldmatrix.trans; sparse: the 1:2 pairs rebuilt in
//     registers; palette: one byte and one table entry a register).
//   * What bounds it on an H100: at decode (M = 8 lanes) the weight is read
//     once for 8 rows, ~2 operations a byte, so bytes (3.35 TB/s), and the
//     loop's job is to have the whole weight requested at once: a tile's 8
//     chunks go to 8 blocks, a 4-stage ring holds a 2048-deep chunk whole,
//     and 6 blocks of 36 KB fit an SM, so tinyllama's widest projection (704
//     blocks) runs in one wave. 128-column blocks, 2 or 4 chunks and an L2
//     prefetch hint measured no faster there (PERF.md). At prefill (M = 512,
//     or a whisper stem conv's 1,500 output pixels) a 64x64 tile does 32
//     operations a staged byte, so the tensor cores' rate bounds it (989
//     TFLOP/s dense bf16), of which mma.sync from 4-warp blocks reaches a
//     fraction; a wgmma body is later work.
//   * A row's bits do not depend on M. K is cut into chunks by the wrapper's
//     plan, a function of (K, N, dtype) alone (kernels/common.py,
//     `chunk_plan`): at most 8 chunks of a multiple of 64. Each chunk's
//     partial sum starts from zero and runs its 16-deep MMA steps in K
//     order; the partials are added to a zero total in chunk order, in fp32,
//     then the epilogue runs once. Only who computes a chunk varies with M:
//     with few output tiles (decode) the chunks of a tile go to the `split`
//     blocks of one thread-block cluster, which add them in rank order
//     through distributed shared memory, each rank a slice of the tile (no
//     workspace, no second launch); with many tiles (prefill) one block walks
//     every chunk with a fresh accumulator and adds each into its total.
//     Every element is the same MMA instruction on the same operands in the
//     same order either way, at any BM.
//   * Ragged shapes take the same path: rows past M, columns past N and K
//     past the matrix are zero-filled in the ring (copies of 0 bytes), and
//     rows that are not 16-byte aligned are staged element by element.
//
// The blocked loop (`matmul_f32`): every fp32 product (the logits head of
// each weight form, fp32 convs), true fp32 FMA, never TF32. Each block owns
// one 64x64 output tile and loops over all of K itself, without
// pipelining, so an element's sum is one fmaf chain in K order whatever M
// is.
//
// An A producer AP of the blocked loop provides
//   __device__ float at(int m, int k) const;
//     one element of A, zero outside the matrix.
// DenseA below reads a row-major matrix.
//
// A B-tile producer P of the blocked loop provides
//   struct Smem;                                  its shared-memory state
//   __device__ void prepare(Smem&) const;         fill it (all threads)
//   template <int ROWS, int COLS, int LDB, int THREADS>
//   __device__ void load(float* dst, const Smem&, int k0, int n0) const;
//     write the dense fp32 ROWS x COLS tile of B at (k0, n0) into dst
//     (leading dimension LDB), zero outside the matrix; k0 is a multiple of
//     16.
//
// An activation producer X of the streaming loop provides
//   template <int BM>
//   __device__ R start(int m0) const;
//     this thread's state for the block's rows m0..m0+BM-1, made once a
//     block before the first step (DenseX: m0 itself; conv2d: each owned
//     row's pixel, decoded once);
//   template <int BM>
//   __device__ void issue(unsigned char* stage, const R& rows, int k0) const;
//     start the copies of the K step at k0 (a multiple of 64): BM rows of 64
//     16-bit values of A (M, K), K k0..k0+63, into the stage's swizzled
//     128-byte rows (row r, element c at `swz(r, c)`), zero outside the
//     matrix (rows past M, K past K). The loop calls it from all THREADS
//     threads; a copy may be a cp.async or a plain shared store.
// A weight producer W of the streaming loop provides
//   static constexpr int kStageBytes;             its share of a ring stage
//   static constexpr int kSharedBytes;            its block-wide shared state
//   __device__ void prepare(unsigned char* shared) const;
//     fill that state (all threads, once the ring's first copies are
//     issued; read after the first step's barrier);
//   __device__ void issue(unsigned char* stage, int k0, int n0) const;
//     start the copies of the K step at k0 (a multiple of 64), columns
//     n0..n0+63, into the stage; what lies outside the matrix may stage as
//     anything finite (the activation's zeros cancel it, or its column is
//     not stored);
//   template <typename T>
//   __device__ void fragment(uint32_t (&a)[4], const unsigned char* stage,
//                            const unsigned char* shared, int kk, int nw,
//                            int lane) const;
//     the A fragment (Wᵀ rows nw..nw+15, K kk..kk+15 of the step) in T.
// An epilogue E provides
//   __device__ float operator()(float acc, int n) const;
//     the fp32 value stored (rounded once to T) for output column n.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "mma.cuh"

namespace repro {
namespace tile {

// fp32: 64x64 output tile, 256 threads of 4x4 outputs, K steps of 16
constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_THREADS = 256;
constexpr int F_LDB = F_BN + 4;

// the stored value is the accumulator itself
struct Identity {
  __device__ float operator()(float acc, int) const { return acc; }
};

// A as a dense row-major (M, K) fp32 matrix
struct DenseA {
  const float* __restrict__ a;
  int M, K;

  __device__ __forceinline__ float at(int m, int k) const {
    return (m < M && k < K) ? a[(size_t)m * K + k] : 0.0f;
  }
};

// B as a dense row-major (K, N) fp32 matrix
struct DenseB {
  const float* __restrict__ b;
  int K, N;

  struct Smem {};

  __device__ void prepare(Smem&) const {}

  template <int ROWS, int COLS, int LDB, int THREADS>
  __device__ void load(float* __restrict__ dst, const Smem&, int k0, int n0) const {
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      const int gk = k0 + r, gn = n0 + c;
      dst[r * LDB + c] = (gk < K && gn < N) ? b[(size_t)gk * N + gn] : 0.0f;
    }
  }
};

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
    prod.template load<F_BK, F_BN, F_LDB, F_THREADS>(Bs, ps, k0, n0);
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

template <typename AP, typename P, typename E>
int launch_f32(const AP& ap, const P& prod, const E& epi, void* out, int M, int N, int K,
               cudaStream_t s) {
  dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM);
  matmul_f32<AP, P, E><<<grid, F_THREADS, 0, s>>>(ap, prod, epi, static_cast<float*>(out), M,
                                                  N, K);
  return cudaGetLastError();
}

// Launch the blocked loop for a dense fp32 A (M, K) and B producer `prod`,
// no epilogue, on `stream`; returns the launch's CUDA error.
template <typename P>
int launch(const P& prod, const void* a, void* out, int M, int N, int K, void* stream) {
  return launch_f32(DenseA{static_cast<const float*>(a), M, K}, prod, Identity{}, out, M, N, K,
                    static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// The streaming loop (bf16 / fp16)
// ---------------------------------------------------------------------------

namespace stream {

constexpr int BN = 64;       // weight columns a block owns: 4 warps x 16
constexpr int BK = 64;       // K a ring stage holds
constexpr int THREADS = 128;
constexpr int STAGES = 4;
constexpr int MAX_SPLIT = 8;  // chunks a plan may have: a portable cluster
constexpr int ROW = 64;       // 16-bit elements a staged row holds (BN = BK = ROW)
constexpr int LDO = BN + 4;   // a row of the fp32 output tile
constexpr int VEC = 8;        // 16-bit elements a 16-byte copy moves

// Element offset of (r, c) in a staged tile of ROW-wide 16-bit rows (128
// bytes, all 32 banks): the 16-byte chunk c / 8 sits at chunk (c / 8) ^ (r %
// 8), so the 8 rows one ldmatrix reads, and the 4 rows of a sparse
// fragment's reads, fall on distinct banks without padding.
__device__ __forceinline__ int swz(int r, int c) {
  return r * ROW + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

// the ring stage of an instance: the activation slice, then the weight's share
template <int BM>
__host__ __device__ constexpr int x_bytes() { return BM * ROW * 2; }

template <int BM, typename W>
__host__ __device__ constexpr int stage_bytes() {
  return (x_bytes<BM>() + W::kStageBytes + 127) / 128 * 128;
}

// the ring and the weight producer's block-wide state after it; the ring is
// reused after the K loop for the fp32 output tile (BM x LDO)
template <int BM, typename W>
constexpr int smem_bytes() {
  constexpr int ring = STAGES * stage_bytes<BM, W>() + W::kSharedBytes, out = BM * LDO * 4;
  return ring > out ? ring : out;
}

// ROWS x ROW 16-bit elements of a row-major (R x Cn, leading dim ld) matrix
// at (r0, c0) into swizzled shared rows: 16-byte copies when `vec` (Cn % 8
// == 0, base 16-byte aligned: a copy is all in or all out), else element by
// element; zero outside the matrix
template <typename T, int ROWS>
__device__ __forceinline__ void stage(T* __restrict__ dst, const T* __restrict__ src, int ld,
                                      int R, int Cn, int r0, int c0, bool vec) {
  constexpr int CPR = ROW / VEC;
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    const int gr = r0 + r, gc = c0 + c;
    T* d = dst + swz(r, c);
    if (vec) {
      const bool in = gr < R && gc < Cn;
      cp_async16(smem_addr(d), src + (in ? (size_t)gr * ld + gc : 0), in);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        d[e] = (gr < R && gc + e < Cn) ? src[(size_t)gr * ld + gc + e] : from_f32<T>(0.0f);
    }
  }
}

// the activation: a dense row-major (M, K) matrix in T; a thread's state is
// the block's first row
template <typename T>
struct DenseX {
  const T* __restrict__ a;
  int M, K;
  bool vec;

  template <int BM>
  __device__ __forceinline__ int start(int m0) const {
    return m0;
  }

  template <int BM>
  __device__ __forceinline__ void issue(unsigned char* st, int m0, int k0) const {
    stage<T, BM>(reinterpret_cast<T*>(st), a, K, M, K, m0, k0, vec);
  }
};

template <typename T>
DenseX<T> dense_x(const void* a, int M, int K) {
  return {static_cast<const T*>(a), M, K,
          (K % VEC == 0) && (reinterpret_cast<uintptr_t>(a) & 15u) == 0};
}

// the weight as a dense row-major (K, N) matrix in T: staged as it is, BK
// rows of BN; Wᵀ fragments by ldmatrix.trans
template <typename T>
struct DenseW {
  const T* __restrict__ w;
  int K, N;
  bool vec;

  static constexpr int kStageBytes = BK * ROW * 2;
  static constexpr int kSharedBytes = 0;

  __device__ __forceinline__ void prepare(unsigned char*) const {}

  __device__ __forceinline__ void issue(unsigned char* st, int k0, int n0) const {
    stage<T, BK>(reinterpret_cast<T*>(st), w, N, K, N, k0, n0, vec);
  }

  template <typename U>
  __device__ __forceinline__ void fragment(uint32_t (&a)[4], const unsigned char* st,
                                           const unsigned char*, int kk, int nw,
                                           int lane) const {
    static_assert(std::is_same_v<T, U>, "a dense weight is stored in the activation's dtype");
    // matrices (n 0-7 | 8-15) x (k 0-7 | 8-15) of Wᵀ: rows k of the stage
    const int k = kk + (lane & 7) + ((lane >> 4) << 3), n = nw + (((lane >> 3) & 1) << 3);
    ldmatrix_x4_trans(a, smem_addr(st + swz(k, n) * 2));
  }
};

template <typename T>
DenseW<T> dense_w(const void* w, int K, int N) {
  return {static_cast<const T*>(w), K, N,
          (N % VEC == 0) && (reinterpret_cast<uintptr_t>(w) & 15u) == 0};
}

// BM/8 B fragments (Xᵀ, K kk..kk+15, rows j*8..j*8+7) from the staged
// activation rows
template <int BM>
__device__ __forceinline__ void x_fragments(uint32_t (&b)[BM / 8][2], uint32_t xs, int kk,
                                            int lane) {
  const int c = kk + (((lane >> 3) & 1) << 3);
  if constexpr (BM == 8) {
    ldmatrix_x2(b[0], xs + swz(lane & 7, c) * 2);
  } else {
#pragma unroll
    for (int j = 0; j < BM / 8; j += 2) {
      const int r = j * 8 + (lane & 7) + ((lane >> 4) << 3);
      uint32_t t[4];
      ldmatrix_x4(t, xs + swz(r, c) * 2);
      b[j][0] = t[0];
      b[j][1] = t[1];
      b[j + 1][0] = t[2];
      b[j + 1][1] = t[3];
    }
  }
}

// One output tile: BN weight columns (blockIdx.x / split) x BM activation
// rows (blockIdx.y). `split` 1: the block walks every chunk of `kc` K
// (a multiple of BK); `split` > 1 (a cluster of `split` blocks along x, one
// per chunk): rank r computes chunk r and adds a slice of the tile.
template <typename T, int BM, typename XP, typename W, typename E>
__global__ void __launch_bounds__(THREADS)
    matmul_stream(const XP xp, const W wp, const E epi, T* __restrict__ C, int M, int N, int K,
                  int kc, int split) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int XB = x_bytes<BM>(), SB = stage_bytes<BM, W>(), NJ = BM / 8;
  const int rank = blockIdx.x % split;
  const int n0 = (blockIdx.x / split) * BN, m0 = blockIdx.y * BM;
  const int kb = split > 1 ? rank * kc : 0;
  const int ke = split > 1 ? min(K, kb + kc) : K;
  const int steps = (ke - kb + BK - 1) / BK, chunk_steps = kc / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = warp * 16;
  const auto rows = xp.template start<BM>(m0);

  auto issue = [&](int s) {
    unsigned char* st = smem + (s % STAGES) * SB;
    xp.template issue<BM>(st, rows, kb + s * BK);
    wp.issue(st + XB, kb + s * BK, n0);
  };
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  // the weight producer's state, built while the ring's copies are in flight
  unsigned char* const shared = smem + STAGES * SB;
  wp.prepare(shared);

  float acc[NJ][4], total[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = total[j][e] = 0.0f;

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 1>();  // step s landed (this thread's copies)
    __syncthreads();              // ... everyone's (and, at s = 0, wp.prepare's state)
    const unsigned char* st = smem + (s % STAGES) * SB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4], b[NJ][2];
      wp.template fragment<T>(a, st + XB, shared, kk, nw, lane);
      x_fragments<BM>(b, smem_addr(st), kk, lane);
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma16816<T>(acc[j], a, b[j][0], b[j][1]);
    }
    if (split == 1 && ((s + 1) % chunk_steps == 0 || s + 1 == steps)) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          total[j][e] = __fadd_rn(total[j][e], acc[j][e]);
          acc[j][e] = 0.0f;
        }
    }
    __syncthreads();  // step s's slot is free
    if (s + STAGES < steps) issue(s + STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the fp32 output tile

  // accumulator layout: c0/c1 at (n = g, m = 2q, 2q+1), c2/c3 at n = g + 8
  float* out = reinterpret_cast<float*>(smem);
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = nw + g + (e >> 1) * 8, m = j * 8 + 2 * q + (e & 1);
      out[m * LDO + n] = split > 1 ? acc[j][e] : total[j][e];
    }

  auto store = [&](int i, float v) {
    const int m = i / BN, n = i % BN, gm = m0 + m, gn = n0 + n;
    if (gm < M && gn < N) C[(size_t)gm * N + gn] = from_f32<T>(epi(v, gn));
  };
  if (split == 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN; i += THREADS) store(i, out[(i / BN) * LDO + i % BN]);
    return;
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every rank's partial is in its shared memory
  for (int i = rank * THREADS + threadIdx.x; i < BM * BN; i += split * THREADS) {
    const int o = (i / BN) * LDO + i % BN;
    float p[MAX_SPLIT];  // every rank's read in flight before the first add
#pragma unroll
    for (int c = 0; c < MAX_SPLIT; ++c)
      p[c] = c < split ? cluster.map_shared_rank(out, c)[o] : 0.0f;
    float t = 0.0f;
#pragma unroll
    for (int c = 0; c < MAX_SPLIT; ++c)
      if (c < split) t = __fadd_rn(t, p[c]);
    store(i, t);
  }
  cluster.sync();  // no rank leaves while another still reads its partial
}

template <typename T, int BM, typename XP, typename W, typename E>
cudaError_t launch_bm(const XP& xp, const W& wp, const E& epi, void* out, int M, int N, int K,
                      int kc, int split, cudaStream_t s) {
  constexpr int smem = smem_bytes<BM, W>();
  static_assert(smem <= 232448, "an H100 block has 227 KB of shared memory");
  auto* kernel = matmul_stream<T, BM, XP, W, E>;
  static bool ready[kMaxDevices] = {};
  cudaError_t err = allow_dynamic_smem(kernel, smem, ready);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN * split, (M + BM - 1) / BM);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, xp, wp, epi, static_cast<T*>(out), M, N, K, kc, split);
}

// Launch the streaming loop for activation rows BM = `bm` (8, 16, 32 or 64)
// with the chunk plan (kc, split): kc a positive multiple of BK; split 1 or
// the plan's chunk count ceil(K / kc), at most MAX_SPLIT.
template <typename T, typename XP, typename W, typename E>
cudaError_t launch(const XP& xp, const W& wp, const E& epi, void* out, int M, int N, int K,
                   int kc, int bm, int split, cudaStream_t s) {
  const int chunks = kc > 0 ? (K + kc - 1) / kc : 0;
  if (kc <= 0 || kc % BK != 0 || chunks > MAX_SPLIT || (split != 1 && split != chunks))
    return cudaErrorInvalidValue;
  switch (bm) {
    case 8: return launch_bm<T, 8>(xp, wp, epi, out, M, N, K, kc, split, s);
    case 16: return launch_bm<T, 16>(xp, wp, epi, out, M, N, K, kc, split, s);
    case 32: return launch_bm<T, 32>(xp, wp, epi, out, M, N, K, kc, split, s);
    case 64: return launch_bm<T, 64>(xp, wp, epi, out, M, N, K, kc, split, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace stream

}  // namespace tile
}  // namespace repro
