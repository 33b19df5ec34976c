// palette_matmul: (M, K) x dequant(int4 nibbles (K/2, N), 16-entry fp32
// codebook) -> (M, N) in the activation's dtype, fp32 accumulation.
//
// Replaces the Pallas TPU kernel `palette_matmul`
// (src/repro/kernels/palette/palette_matmul.py:88, body `_kernel` at :63).
// The TPU kernel carries its accumulator across a sequential K grid axis and
// decodes each packed (bk/2, bn) block at the MXU input with a 4-level select
// tree (no VMEM gather). Only the packed bytes cross device memory here too:
// a dense weight is never written, to device or to shared memory.
//
// bf16 runs the streaming loop of tile_matmul.cuh with the PaletteW producer
// below. Each 64-deep K step's packed bytes, 32 nibble rows of 64 columns (2
// KB), land in the cp.async ring as they are, one 16-byte copy a thread. In
// mma.m16n8k16's A fragment of Wᵀ each 32-bit register holds the (k, k+1)
// pair of one column n with k even: exactly one packed byte (low nibble the
// even row). So a register is one byte read and one read of a 256-entry
// table that maps a byte to its two codebook entries, each rounded once to
// the activation's dtype (the reference's `w.astype(a.dtype)`), packed into
// a uint32_t: 1 KB of shared memory, built once a block; no lane exchange. A
// staged row's 16-byte chunks are swizzled by row pair, so the 4 rows of a
// fragment's byte reads fall on distinct banks (64-byte rows p and p + 2
// would share them). The K chunks, their order and the cluster split are
// anemm's (`chunk_plan`), so a row's bits do not depend on M. Bytes that
// stage outside the matrix decode to codebook entry 0 and meet the
// activation's zero columns (past K) or are not stored (past N), as the
// reference's zero padding of the packed array decodes to entry 0.
// fp32 (the logits head) runs the blocked loop (true fp32 FMA), one block
// over all of K in order, with the PaletteB producer.
//
// What bounds it on an H100: at decode (M = lanes, about 8) the packed
// weight is read once for M rows, so it is bound by device-memory bytes
// (3.35 TB/s): a quarter of the bf16 weight's bytes, half of sparse's. At
// prefill (M = 512) it is bound by the tensor cores, as anemm is; a fragment
// costs 4 byte and 4 table reads from shared memory, shared by the BM/8 MMAs
// that use it.
#include "tile_matmul.cuh"

namespace {

using namespace repro;
namespace st = repro::tile::stream;

// the blocked loop's producer (fp32): the dense tile decoded into shared
// memory through the 64-byte codebook
struct PaletteB {
  const uint8_t* __restrict__ packed;  // (K/2, N): low nibble row 2p, high row 2p+1
  const float* __restrict__ lut;       // (16,)
  int K, N;

  struct Smem {
    float lut[16];
  };

  __device__ void prepare(Smem& s) const {
    if (threadIdx.x < 16) s.lut[threadIdx.x] = lut[threadIdx.x];
  }

  // every byte load in flight before the first codebook read
  template <int ROWS, int COLS, int LDB, int THREADS>
  __device__ void load(float* __restrict__ dst, const Smem& s, int k0, int n0) const {
    constexpr int PER = (ROWS / 2) * COLS / THREADS;
    static_assert((ROWS / 2) * COLS % THREADS == 0, "the tile splits evenly");
    const int k2 = K / 2, p0 = k0 / 2;
    uint8_t bytes[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int p = p0 + i / COLS, gn = n0 + i % COLS;
      bytes[j] = (p < k2 && gn < N) ? packed[(size_t)p * N + gn] : uint8_t(0);
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = i / COLS, c = i % COLS;
      const bool in = p0 + r < k2 && n0 + c < N;
      dst[(2 * r) * LDB + c] = in ? s.lut[bytes[j] & 15] : 0.0f;
      dst[(2 * r + 1) * LDB + c] = in ? s.lut[bytes[j] >> 4] : 0.0f;
    }
  }
};

// the streaming loop's producer (16-bit T): a stage holds BK/2 packed rows of
// BN bytes; the block's state is the byte -> entry pair table
template <typename T>
struct PaletteW {
  const uint8_t* __restrict__ packed;
  const float* __restrict__ lut;
  int K, N;
  bool vec;  // N % 16 == 0, packed 16-byte aligned

  static constexpr int kRows = st::BK / 2;  // packed rows a step
  static constexpr int kStageBytes = kRows * st::BN;
  static constexpr int kSharedBytes = 256 * 4;

  // byte offset of packed row r, column c of a stage: 64-byte rows, the
  // 16-byte chunk c / 16 at chunk (c / 16) ^ ((r / 2) & 1)
  static __device__ __forceinline__ int at(int r, int c) {
    return r * st::BN + ((c >> 4) ^ ((r >> 1) & 1)) * 16 + (c & 15);
  }

  __device__ __forceinline__ void prepare(unsigned char* shared) const {
    uint32_t* table = reinterpret_cast<uint32_t*>(shared);
    for (int b = threadIdx.x; b < 256; b += st::THREADS) {
      const T lo = from_f32<T>(lut[b & 15]), hi = from_f32<T>(lut[b >> 4]);
      table[b] = uint32_t(*reinterpret_cast<const uint16_t*>(&lo)) |
                 (uint32_t(*reinterpret_cast<const uint16_t*>(&hi)) << 16);
    }
  }

  __device__ __forceinline__ void issue(unsigned char* stage, int k0, int n0) const {
    constexpr int CPR = st::BN / 16;  // 16-byte copies a packed row
    const int r0 = k0 / 2, k2 = K / 2;
    for (int i = threadIdx.x; i < kRows * CPR; i += st::THREADS) {
      const int r = i / CPR, c = (i % CPR) * 16, gr = r0 + r, gc = n0 + c;
      unsigned char* d = stage + at(r, c);
      if (vec) {
        const bool in = gr < k2 && gc < N;
        cp_async16(smem_addr(d), packed + (in ? (size_t)gr * N + gc : 0), in);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          d[e] = (gr < k2 && gc + e < N) ? packed[(size_t)gr * N + gc + e] : 0;
      }
    }
  }

  // a0/a1: pair kk/2 + q at columns nw + g / nw + g + 8; a2/a3: pair kk/2 + 4 + q
  template <typename U>
  __device__ __forceinline__ void fragment(uint32_t (&a)[4], const unsigned char* stage,
                                           const unsigned char* shared, int kk, int nw,
                                           int lane) const {
    static_assert(std::is_same_v<T, U>, "the table holds the activation's dtype");
    const uint32_t* table = reinterpret_cast<const uint32_t*>(shared);
    const int g = lane / 4, q = lane % 4;
    uint8_t bytes[4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        bytes[2 * h + j] = stage[at(kk / 2 + q + 4 * h, nw + g + 8 * j)];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = table[bytes[i]];
  }
};

}  // namespace

// a (M, K) fp32 or bf16 (dtype code), packed (K/2, N) uint8, lut (16,) fp32,
// out (M, N) in a's dtype; all row-major and contiguous, K even. kc, bm,
// split: the streaming loop's plan (bf16; fp32 takes split 1 and ignores kc
// and bm).
extern "C" int palette_matmul_launch(const void* a, const void* packed, const void* lut,
                                     void* out, int M, int N, int K, int dtype, int kc, int bm,
                                     int split, void* stream) {
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* l = static_cast<const float*>(lut);
  if (dtype == kF32)
    return split != 1 ? cudaErrorInvalidValue
                      : tile::launch(PaletteB{p, l, K, N}, a, out, M, N, K, stream);
  if (dtype != kBF16) return cudaErrorInvalidValue;
  using T = __nv_bfloat16;
  const PaletteW<T> wp{p, l, K, N,
                       (N % 16 == 0) && (reinterpret_cast<uintptr_t>(packed) & 15u) == 0};
  return st::launch<T>(st::dense_x<T>(a, M, K), wp, tile::Identity{}, out, M, N, K, kc, bm,
                       split, static_cast<cudaStream_t>(stream));
}
