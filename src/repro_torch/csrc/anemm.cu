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
// It is the shared tile loop (tile_matmul.cuh) with a dense B producer and
// the epilogue below: 16-bit inputs go through WMMA (mma.sync on tensor
// cores) from shared-memory tiles loaded with 16-byte vectors where aligned,
// fp32 inputs through true fp32 FMA (never TF32) with a 4x4 register
// micro-tile per thread. Neither pipelines its loads (no cp.async/TMA, no
// wgmma), so both sit well below their bound; that is later work.
#include "tile_matmul.cuh"

namespace {

using namespace repro;

constexpr float kCeiling = 32768.0f;  // hal.ACCUM_OUT_CEILING (2^15)

// scale -> bias -> saturation; __fmul_rn/__fadd_rn keep the two steps
// separately rounded, as the reference computes them (no FMA contraction)
struct AneEpilogue {
  const float* __restrict__ scale;  // (N,) or null
  const float* __restrict__ bias;   // (N,) or null
  int ane_mode;

  __device__ float operator()(float acc, int n) const {
    if (scale != nullptr) acc = __fmul_rn(acc, scale[n]);
    if (bias != nullptr) acc = __fadd_rn(acc, bias[n]);
    if (ane_mode) {
      if (acc >= kCeiling) acc = INFINITY;
      if (acc <= -kCeiling) acc = -INFINITY;
    }
    return acc;
  }
};

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
      tile::load_tile<T, ROWS, COLS, LDB, THREADS>(dst, b, N, K, N, k0, n0, vec);
    } else {
      for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
        const int r = i / COLS, c = i % COLS;
        const int gk = k0 + r, gn = n0 + c;
        dst[r * LDB + c] = (gk < K && gn < N) ? b[(size_t)gk * N + gn] : 0.0f;
      }
    }
  }
};

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T>
DenseB<T> dense_b(const void* b, int K, int N) {
  return {static_cast<const T*>(b), K, N, (N % tile::H_VEC == 0) && aligned16(b)};
}

}  // namespace

// a (M, K), b (K, N), out (M, N): row-major, contiguous, one dtype.
// scale/bias: (N,) fp32 or null.
extern "C" int anemm_launch(const void* a, const void* b, const void* scale, const void* bias,
                            void* out, int M, int N, int K, int dtype, int ane_mode,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AneEpilogue epi{static_cast<const float*>(scale), static_cast<const float*>(bias),
                        ane_mode};
  if (dtype == kF32) return tile::launch_f32(dense_b<float>(b, K, N), epi, a, out, M, N, K, s);
  if (dtype == kBF16)
    return tile::launch_mma<__nv_bfloat16>(dense_b<__nv_bfloat16>(b, K, N), epi, a, out, M, N,
                                           K, s);
  if (dtype == kF16)
    return tile::launch_mma<__half>(dense_b<__half>(b, K, N), epi, a, out, M, N, K, s);
  return cudaErrorInvalidValue;
}
