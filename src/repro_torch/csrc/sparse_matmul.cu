// sparse_matmul: (M, K) x rebuild(1:2 pair-sparse values (K/2, N), selector
// bits (K/16, N)) -> (M, N) in the activation's dtype, fp32 accumulation.
//
// Replaces the Pallas TPU kernel `sparse_matmul`
// (src/repro/kernels/sparse/sparse_matmul.py:85, body `_kernel` at :58).
// The TPU kernel unpacks the selector bits with shift/mask and rebuilds the
// dense (bk, bn) block at the MXU input, carrying its accumulator across a
// sequential K grid axis. Here each block owns one output tile and loops over
// K itself (tile_matmul.cuh); each K step reads the (BK/2, BN) value tile
// and its selector bytes, and for pair p puts the value at row 2p and zero at
// row 2p+1 when bit p is clear, the reverse when it is set, each value
// converted through fp32 to the activation's dtype. WMMA (bf16) or fp32 FMA
// (fp32, the logits head) consumes the dense shared-memory tile. Only the
// packed bytes cross device memory.
//
// What bounds it on an H100: at decode (M = lanes, about 8) the values and
// selector bits are read once for M rows, so it is bound by device-memory
// bytes (3.35 TB/s): about 0.53x the bf16 weight's bytes. This first version
// does not pipeline its loads (no cp.async/TMA, no wgmma) and is
// latency-bound in its K loop, far from that bound. A 1:2 pattern per pair is
// also a 2:4 pattern, so a later version can feed `mma.sp` directly.
#include "tile_matmul.cuh"

namespace {

using namespace repro;

template <typename V>
struct SparseB {
  const V* __restrict__ values;          // (K/2, N) survivors
  const uint8_t* __restrict__ selector;  // (K/16, N): bit j of byte r = pair 8r+j odd
  int K, N;

  struct Smem {};

  __device__ void prepare(Smem&) const {}

  template <typename T, int ROWS, int COLS, int LDB, int THREADS>
  __device__ void load(T* __restrict__ dst, const Smem&, int k0, int n0) const {
    const int k2 = K / 2, p0 = k0 / 2;
    for (int i = threadIdx.x; i < (ROWS / 2) * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      const int p = p0 + r, gn = n0 + c;
      T v = from_f32<T>(0.0f);
      int odd = 0;
      if (p < k2 && gn < N) {
        v = from_f32<T>(to_f32<V>(values[(size_t)p * N + gn]));
        odd = (selector[(size_t)(p >> 3) * N + gn] >> (p & 7)) & 1;
      }
      dst[(2 * r + odd) * LDB + c] = v;
      dst[(2 * r + 1 - odd) * LDB + c] = from_f32<T>(0.0f);
    }
  }
};

template <typename V>
int launch_values(const void* a, const void* values, const void* selector, void* out, int M,
                  int N, int K, int dtype, void* stream) {
  const SparseB<V> prod{static_cast<const V*>(values), static_cast<const uint8_t*>(selector), K,
                        N};
  return repro::tile::launch(prod, a, out, M, N, K, dtype, stream);
}

}  // namespace

// a (M, K) fp32 or bf16 (dtype code), values (K/2, N) fp16 or bf16 (vdtype
// code), selector (K/16, N) uint8, out (M, N) in a's dtype; all row-major
// and contiguous, K % 16 == 0.
extern "C" int sparse_matmul_launch(const void* a, const void* values, const void* selector,
                                    void* out, int M, int N, int K, int dtype, int vdtype,
                                    void* stream) {
  if (vdtype == repro::kF16)
    return launch_values<__half>(a, values, selector, out, M, N, K, dtype, stream);
  if (vdtype == repro::kBF16)
    return launch_values<__nv_bfloat16>(a, values, selector, out, M, N, K, dtype, stream);
  return cudaErrorInvalidValue;
}
