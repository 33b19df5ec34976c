// palette_matmul: (M, K) x dequant(int4 nibbles (K/2, N), 16-entry fp32
// codebook) -> (M, N) in the activation's dtype, fp32 accumulation.
//
// Replaces the Pallas TPU kernel `palette_matmul`
// (src/repro/kernels/palette/palette_matmul.py:88, body `_kernel` at :63).
// The TPU kernel carries its accumulator across a sequential K grid axis and
// decodes each packed (bk/2, bn) block at the MXU input with a 4-level select
// tree (no VMEM gather). Here each block owns one output tile and loops over
// K itself (tile_matmul.cuh); the codebook sits in shared memory (64
// bytes), and each K step reads the (BK/2, BN) nibble tile, looks up both
// nibbles of every byte, rounds each entry once to the activation's dtype
// (the reference's `w.astype(a.dtype)`) and writes the dense (BK, BN) tile to
// shared memory, where WMMA (bf16) or fp32 FMA (fp32, the logits head)
// consumes it. Only the packed bytes cross device memory: a dense weight is
// never written.
//
// What bounds it on an H100: at decode (M = lanes, about 8) the packed
// weight is read once for M rows, so it is bound by device-memory bytes
// (3.35 TB/s): a quarter of the bf16 weight's bytes. The K loop is latency-
// bound, so each thread issues its whole share of a K step's nibble tile as
// one 16-byte load before the first LUT read rather than one byte load per
// read. It does not pipeline its loads across K steps (no cp.async/TMA, no
// wgmma), so it stays far from its bound; a faster design is later work.
#include "tile_matmul.cuh"

namespace {

using namespace repro;

struct PaletteB {
  const uint8_t* __restrict__ packed;  // (K/2, N): low nibble row 2p, high row 2p+1
  const float* __restrict__ lut;       // (16,)
  int K, N;
  int vec;  // N % 16 == 0 and packed 16-byte aligned

  struct Smem {
    float lut[16];
  };

  __device__ void prepare(Smem& s) const {
    if (threadIdx.x < 16) s.lut[threadIdx.x] = lut[threadIdx.x];
  }

  template <typename T, int ROWS, int COLS, int LDB, int THREADS>
  __device__ void load(T* __restrict__ dst, const Smem& s, int k0, int n0) const {
    constexpr int PER = (ROWS / 2) * COLS / THREADS;
    static_assert((ROWS / 2) * COLS % THREADS == 0, "the tile splits evenly");
    const int k2 = K / 2, p0 = k0 / 2;
    if constexpr (PER == 16 && sizeof(T) == 2 && COLS % 16 == 0) {
      // the WMMA tile: one 16-byte load of 16 consecutive bytes of one packed
      // row, decoded to 2 x 16 values and stored as four 16-byte vectors
      const int i0 = threadIdx.x * 16;
      const int r = i0 / COLS, c = i0 % COLS;
      const int p = p0 + r, gn = n0 + c;
      alignas(16) uint8_t bytes[16];
      if (vec && p < k2 && gn + 16 <= N) {
        *reinterpret_cast<uint4*>(bytes) =
            *reinterpret_cast<const uint4*>(packed + (size_t)p * N + gn);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          bytes[e] = (p < k2 && gn + e < N) ? packed[(size_t)p * N + gn + e] : uint8_t(0);
      }
      alignas(16) T lo[16], hi[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const bool in = p < k2 && gn + e < N;
        lo[e] = from_f32<T>(in ? s.lut[bytes[e] & 15] : 0.0f);
        hi[e] = from_f32<T>(in ? s.lut[bytes[e] >> 4] : 0.0f);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // 16-byte aligned: LDB * sizeof(T) and c * sizeof(T) are multiples of 16
        *reinterpret_cast<uint4*>(dst + (2 * r) * LDB + c + 8 * h) =
            reinterpret_cast<const uint4*>(lo)[h];
        *reinterpret_cast<uint4*>(dst + (2 * r + 1) * LDB + c + 8 * h) =
            reinterpret_cast<const uint4*>(hi)[h];
      }
    } else {
      // the fp32 tile (two bytes a thread): every load in flight before the
      // first LUT read
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
        dst[(2 * r) * LDB + c] = from_f32<T>(in ? s.lut[bytes[j] & 15] : 0.0f);
        dst[(2 * r + 1) * LDB + c] = from_f32<T>(in ? s.lut[bytes[j] >> 4] : 0.0f);
      }
    }
  }
};

}  // namespace

// a (M, K) fp32 or bf16 (dtype code), packed (K/2, N) uint8, lut (16,) fp32,
// out (M, N) in a's dtype; all row-major and contiguous, K even.
extern "C" int palette_matmul_launch(const void* a, const void* packed, const void* lut,
                                     void* out, int M, int N, int K, int dtype, void* stream) {
  const int vec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(packed) & 15u) == 0;
  const PaletteB prod{static_cast<const uint8_t*>(packed), static_cast<const float*>(lut), K, N,
                      vec};
  return repro::tile::launch(prod, a, out, M, N, K, dtype, stream);
}
