// sparse_matmul: (M, K) x rebuild(1:2 pair-sparse values (K/2, N), selector
// bits (K/16, N)) -> (M, N) in the activation's dtype, fp32 accumulation.
//
// Replaces the Pallas TPU kernel `sparse_matmul`
// (src/repro/kernels/sparse/sparse_matmul.py:85, body `_kernel` at :58).
// The TPU kernel unpacks the selector bits with shift/mask and rebuilds the
// dense (bk, bn) block at the MXU input, adding each block's dot product to
// an accumulator carried across a sequential K grid axis. Only the packed
// bytes cross device memory here too: a dense weight is never written.
//
// bf16 runs the streaming loop of tile_matmul.cuh with the SparseW producer
// below: each 64-deep K step's raw (32, 64) value tile and (4, 64) selector
// bytes land in the cp.async ring as they are, 16 bytes a copy; a warp then
// builds its MMA A fragments (Wᵀ, the weight's N on the MMA's 16-row side)
// straight from them. One fragment register holds one pair (rows 2p and
// 2p+1 of one column): the value, converted through fp32 to the
// activation's dtype, in the low half when bit p is clear and in the high
// half when it is set, zero in the other half. The K chunks, their order and
// the cluster split are anemm's (`chunk_plan`), so a row's bits do not
// depend on M. fp32 (the logits head) runs the blocked loop (true fp32 FMA),
// one block over all of K in order, with the scalar SparseB producer.
//
// What bounds it on an H100: at decode (M = 8 lanes) the values and
// selector bits are read once for 8 rows, so it is bound by device-memory
// bytes (3.35 TB/s), 0.53x the bf16 weight's bytes. At prefill (M = 512) it
// is bound by the tensor cores, as anemm is; a fragment costs 4 value and 2
// selector reads from shared memory, shared by the BM/8 MMAs that use it. A
// 1:2 pattern per pair is also a 2:4 pattern: `mma.sp` would halve the MMA
// work at prefill, but not the bytes at decode, and is not used.
#include "tile_matmul.cuh"

namespace {

using namespace repro;
namespace st = repro::tile::stream;

// the blocked loop's producer (fp32): the dense tile rebuilt in shared memory
template <typename V>
struct SparseB {
  const V* __restrict__ values;          // (K/2, N) survivors
  const uint8_t* __restrict__ selector;  // (K/16, N): bit j of byte r = pair 8r+j odd
  int K, N;

  struct Smem {};

  __device__ void prepare(Smem&) const {}

  template <int ROWS, int COLS, int LDB, int THREADS>
  __device__ void load(float* __restrict__ dst, const Smem&, int k0, int n0) const {
    const int k2 = K / 2, p0 = k0 / 2;
    for (int i = threadIdx.x; i < (ROWS / 2) * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      const int p = p0 + r, gn = n0 + c;
      float v = 0.0f;
      int odd = 0;
      if (p < k2 && gn < N) {
        v = to_f32<V>(values[(size_t)p * N + gn]);
        odd = (selector[(size_t)(p >> 3) * N + gn] >> (p & 7)) & 1;
      }
      dst[(2 * r + odd) * LDB + c] = v;
      dst[(2 * r + 1 - odd) * LDB + c] = 0.0f;
    }
  }
};

// the streaming loop's producer (bf16): a stage holds BK/2 swizzled value
// rows of BN, then BK/16 selector rows of BN bytes
template <typename V>
struct SparseW {
  const V* __restrict__ values;
  const uint8_t* __restrict__ selector;
  int K, N;
  bool vec_v;  // N % 8 == 0, values 16-byte aligned
  bool vec_s;  // N % 16 == 0, selector 16-byte aligned

  static constexpr int kValueBytes = st::BK / 2 * st::ROW * 2;
  static constexpr int kStageBytes = kValueBytes + st::BK / 16 * st::BN;
  static constexpr int kSharedBytes = 0;

  __device__ __forceinline__ void prepare(unsigned char*) const {}

  __device__ __forceinline__ void issue(unsigned char* stage, int k0, int n0) const {
    st::stage<V, st::BK / 2>(reinterpret_cast<V*>(stage), values, N, K / 2, N, k0 / 2, n0,
                             vec_v);
    uint8_t* sel = stage + kValueBytes;
    constexpr int CPR = st::BN / 16;  // 16-byte copies a selector row
    const int r0 = k0 / 16;
    for (int i = threadIdx.x; i < st::BK / 16 * CPR; i += st::THREADS) {
      const int r = i / CPR, c = (i % CPR) * 16, gr = r0 + r, gc = n0 + c;
      if (vec_s) {
        const bool in = gr < K / 16 && gc < N;
        cp_async16(smem_addr(sel + r * st::BN + c),
                   selector + (in ? (size_t)gr * N + gc : 0), in);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          sel[r * st::BN + c + e] =
              (gr < K / 16 && gc + e < N) ? selector[(size_t)gr * N + gc + e] : 0;
      }
    }
  }

  // a0/a1: pair kk/2 + q at columns nw + g / nw + g + 8; a2/a3: pair kk/2 + 4 + q
  template <typename T>
  __device__ __forceinline__ void fragment(uint32_t (&a)[4], const unsigned char* stage,
                                           const unsigned char*, int kk, int nw,
                                           int lane) const {
    const V* v = reinterpret_cast<const V*>(stage);
    const uint8_t* sel = stage + kValueBytes + (kk / 16) * st::BN;
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = nw + g + 8 * r;
      const int bits = sel[n];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = q + 4 * h;  // the pair's bit in the selector byte
        const T t = from_f32<T>(to_f32<V>(v[st::swz(kk / 2 + p, n)]));
        const uint32_t u = *reinterpret_cast<const uint16_t*>(&t);
        a[2 * h + r] = ((bits >> p) & 1) ? u << 16 : u;
      }
    }
  }
};

template <typename V>
int launch_values(const void* a, const void* values, const void* selector, void* out, int M,
                  int N, int K, int dtype, int kc, int bm, int split, void* stream) {
  const auto* v = static_cast<const V*>(values);
  const auto* sel = static_cast<const uint8_t*>(selector);
  if (dtype == kF32)
    return split != 1 ? cudaErrorInvalidValue
                      : tile::launch(SparseB<V>{v, sel, K, N}, a, out, M, N, K, stream);
  if (dtype != kBF16) return cudaErrorInvalidValue;
  const SparseW<V> wp{v, sel, K, N,
                      (N % 8 == 0) && (reinterpret_cast<uintptr_t>(values) & 15u) == 0,
                      (N % 16 == 0) && (reinterpret_cast<uintptr_t>(selector) & 15u) == 0};
  return st::launch<__nv_bfloat16>(st::dense_x<__nv_bfloat16>(a, M, K), wp, tile::Identity{},
                                   out, M, N, K, kc, bm, split,
                                   static_cast<cudaStream_t>(stream));
}

}  // namespace

// a (M, K) fp32 or bf16 (dtype code), values (K/2, N) fp16 or bf16 (vdtype
// code), selector (K/16, N) uint8, out (M, N) in a's dtype; all row-major
// and contiguous, K % 16 == 0. kc, bm, split: the streaming loop's plan
// (bf16; fp32 takes split 1 and ignores kc and bm).
extern "C" int sparse_matmul_launch(const void* a, const void* values, const void* selector,
                                    void* out, int M, int N, int K, int dtype, int vdtype,
                                    int kc, int bm, int split, void* stream) {
  if (vdtype == repro::kF16)
    return launch_values<__half>(a, values, selector, out, M, N, K, dtype, kc, bm, split,
                                 stream);
  if (vdtype == repro::kBF16)
    return launch_values<__nv_bfloat16>(a, values, selector, out, M, N, K, dtype, kc, bm,
                                        split, stream);
  return cudaErrorInvalidValue;
}
