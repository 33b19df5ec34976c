// conv2d: direct NHWC convolution, HWIO weights, fp32 accumulation, with the
// bias / ANE saturation / fused LUT-activation epilogue at the output port.
//
// Replaces the Pallas TPU kernel `conv2d` (src/repro/kernels/conv/conv2d.py:95,
// body `_kernel` at :55). The TPU kernel keeps one padded image in VMEM and
// runs KH*KW tap matmuls, each a strided spatial slice against a (Cin, Cout)
// weight plane, into an fp32 scratch. Here the convolution is an implicit
// GEMM: M = B*OH*OW output pixels, N = Cout, K = KH*KW*Cin taken tap-major
// and channel-minor, which is the HWIO weight read as a dense (KH*KW*Cin,
// Cout) matrix. A(m, k) = x[b, oy*sh + i - ph_lo, ox*sw + j - pw_lo, c],
// zero outside the image, so the SAME pads of `pad_explicit` apply without
// padding anything in device memory. The output is row-major (M, N), which
// is NHWC.
//
// bf16 / fp16 run the streaming loop of tile_matmul.cuh: the weight through
// `stream::dense_w`, the activation through the ConvX producer below, which
// gathers the implicit GEMM's rows into the ring. Each thread owns the same
// rows of every stage, so it decodes their pixels (b, oy, ox) once a block;
// a K step costs it one tap/channel decode. Where Cin % 8 == 0 (whisper's 80
// and 768 mel and model widths) a 16-byte chunk is 8 channels of one tap:
// one cp.async, or a copy of 0 source bytes (zeros) where the tap falls on a
// pad; other Cin stage element by element. K is summed in anemm's chunks
// (`chunk_plan`), so an image's bits do not depend on the batch beside it.
// fp32 runs the blocked loop (true fp32 FMA), one block over all of K in
// order, reading A element by element. The epilogue (epilogue.cuh) adds the
// bias, saturates in ANE mode and, with `epilogue=`, rounds to the output
// dtype and runs the shared lut_eval, so fused equals conv-then-act_lut bit
// for bit.
//
// What bounds it on an H100: whisper-small's stem convs are short and wide
// (K = 240 or 2304, N = 768, M = 1500 or 3000 per request); in bf16 the wider
// one is bound by tensor-core operations (5.3 GFLOP, 5.4 us at 989
// TFLOP/s), the narrower by its bytes. Both are prefill-shaped tiles (288
// and 564 of them), so one block walks all of a tile's chunks, at the rate
// mma.sync from 4-warp blocks reaches (a wgmma body is later work).
#include "epilogue.cuh"

namespace {

using namespace repro;
namespace st = repro::tile::stream;

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund-Montgomery,
// as CUTLASS's FastDivmod): the divisor is fixed for a launch, so the
// magic is made on the host, and neither a block's pixel decode nor a K
// step's tap decode costs a division
struct FastDiv {
  unsigned d, mul, shr;

  static FastDiv of(int d) {
    if (d == 1) return {1, 0, 0};
    int l = 0;
    while ((1u << l) < unsigned(d)) ++l;  // ceil(log2 d)
    const unsigned p = 31 + l;
    return {unsigned(d), unsigned(((1ull << p) + d - 1) / d), p - 32};
  }

  __device__ __forceinline__ int operator()(int n) const {
    return d == 1 ? n : int(__umulhi(unsigned(n), mul) >> shr);
  }
};

// the convolution's geometry: A (M, K) gathered from an NHWC image
struct ConvShape {
  int H, W, Cin, OH, OW, KW, SH, SW, PH, PW;  // PH, PW: the low-side pads
  int M, K;                                   // B*OH*OW, KH*KW*Cin
};

// fp32 A producer of the blocked loop: one element at a time
struct ConvA {
  const float* __restrict__ x;  // (B, H, W, Cin)
  ConvShape g;

  __device__ __forceinline__ float at(int m, int k) const {
    if (m >= g.M || k >= g.K) return 0.0f;
    const int ox = m % g.OW, t = m / g.OW;
    const int oy = t % g.OH, b = t / g.OH;
    const int c = k % g.Cin, tap = k / g.Cin;
    const int iy = oy * g.SH + tap / g.KW - g.PH, ix = ox * g.SW + tap % g.KW - g.PW;
    if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) return 0.0f;
    return x[((static_cast<long long>(b) * g.H + iy) * g.W + ix) * g.Cin + c];
  }
};

// the streaming loop's activation producer (16-bit T). Chunk i of a stage
// (BM rows x 8 chunks of 8 values) goes to thread i % THREADS: a thread's
// chunk column is threadIdx.x % 8 in every step, its rows threadIdx.x / 8 +
// 16 t.
template <typename T>
struct ConvX {
  const T* __restrict__ x;
  ConvShape g;
  FastDiv by_cin, by_kw, by_ow, by_oh;
  bool vec;  // Cin % 8 == 0 and x 16-byte aligned

  static constexpr int kCols = st::ROW / st::VEC;  // chunks a staged row
  static constexpr int kStride = st::THREADS / kCols;  // rows between a thread's rows
  static constexpr int kFar = -(1 << 28);          // an input row no tap reaches

  // a thread's rows: the top-left input cell of each owned output pixel
  // (kFar for rows past M or past BM), and x's offset of that cell (which
  // may lie on a pad)
  template <int R>
  struct Rows {
    int iy[R], ix[R];
    long long cell[R];
  };

  template <int BM>
  __host__ __device__ static constexpr int rows_per_thread() {
    return (BM * kCols + st::THREADS - 1) / st::THREADS;
  }

  template <int BM>
  __device__ __forceinline__ auto start(int m0) const {
    Rows<rows_per_thread<BM>()> rows;
#pragma unroll
    for (int t = 0; t < rows_per_thread<BM>(); ++t) {
      const int r = threadIdx.x / kCols + kStride * t, m = m0 + r;
      rows.iy[t] = rows.ix[t] = kFar;
      rows.cell[t] = 0;
      if (r < BM && m < g.M) {
        const int q = by_ow(m), b = by_oh(q), ox = m - q * g.OW, oy = q - b * g.OH;
        rows.iy[t] = oy * g.SH - g.PH;
        rows.ix[t] = ox * g.SW - g.PW;
        rows.cell[t] = ((static_cast<long long>(b) * g.H + rows.iy[t]) * g.W + rows.ix[t]) * g.Cin;
      }
    }
    return rows;
  }

  // tap (i, j), channel ch of K index k (k < K)
  struct Tap {
    int i, j, ch;
  };

  __device__ __forceinline__ Tap tap(int k) const {
    const int t = by_cin(k), i = by_kw(t);
    return {i, t - i * g.KW, k - t * g.Cin};
  }

  // x's offset of row t's tap, or -1 where the tap falls on a pad
  template <typename R>
  __device__ __forceinline__ long long offset(const R& rows, int t, const Tap& p) const {
    const int iy = rows.iy[t] + p.i, ix = rows.ix[t] + p.j;
    if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) return -1;
    return rows.cell[t] + (static_cast<long long>(p.i) * g.W + p.j) * g.Cin + p.ch;
  }

  template <int BM, typename R>
  __device__ __forceinline__ void issue(unsigned char* stage, const R& rows, int k0) const {
    T* dst = reinterpret_cast<T*>(stage);
    const int c = (threadIdx.x % kCols) * st::VEC, k = k0 + c;
    const Tap p = tap(min(k, g.K - 1));  // vec: the chunk's 8 channels lie in this tap
#pragma unroll
    for (int t = 0; t < rows_per_thread<BM>(); ++t) {
      const int r = threadIdx.x / kCols + kStride * t;
      if (BM * kCols < st::THREADS && r >= BM) return;  // BM = 8: half the threads idle
      T* d = dst + st::swz(r, c);
      if (vec) {
        const long long off = k < g.K ? offset(rows, t, p) : -1;
        cp_async16(smem_addr(d), x + (off >= 0 ? off : 0), off >= 0);
      } else {
#pragma unroll
        for (int e = 0; e < st::VEC; ++e) {
          const long long off = k + e < g.K ? offset(rows, t, tap(k + e)) : -1;
          d[e] = off >= 0 ? x[off] : from_f32<T>(0.0f);
        }
      }
    }
  }
};

template <typename T>
int run(const void* x, const void* w, const float* bias, const float* lut, void* out,
        const ConvShape& g, int N, int ane_mode, int kc, int bm, int split, cudaStream_t s) {
  const ConvX<T> xp{static_cast<const T*>(x), g, FastDiv::of(g.Cin), FastDiv::of(g.KW),
                    FastDiv::of(g.OW), FastDiv::of(g.OH),
                    (g.Cin % st::VEC == 0) && (reinterpret_cast<uintptr_t>(x) & 15u) == 0};
  return with_ane<T>(nullptr, bias, lut, ane_mode, [&](const auto& epi) {
    return st::launch<T>(xp, st::dense_w<T>(w, g.K, N), epi, out, g.M, N, g.K, kc, bm, split,
                         s);
  });
}

}  // namespace

// x (B, H, W, Cin) NHWC, w (KH, KW, Cin, Cout) HWIO, out (B, OH, OW, Cout):
// contiguous, one dtype (code). bias: (Cout,) fp32 or null; lut: the fused
// activation's kLutFloats table or null. PH, PW: the low-side explicit pads.
// kc, bm, split: the streaming loop's plan for (M, K, N) = (B*OH*OW,
// KH*KW*Cin, Cout) (bf16 / fp16; fp32 takes split 1 and ignores kc and bm).
extern "C" int conv2d_launch(const void* x, const void* w, const void* bias, const void* lut,
                             void* out, int B, int H, int W, int Cin, int Cout, int KH, int KW,
                             int SH, int SW, int PH, int PW, int OH, int OW, int dtype,
                             int ane_mode, int kc, int bm, int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const float*>(bias);
  const auto* l = static_cast<const float*>(lut);
  const ConvShape g{H, W, Cin, OH, OW, KW, SH, SW, PH, PW, B * OH * OW, KH * KW * Cin};
  if (dtype == kF32)
    return split != 1 ? cudaErrorInvalidValue
                      : launch_ane(ConvA{static_cast<const float*>(x), g},
                                   tile::DenseB{static_cast<const float*>(w), g.K, Cout},
                                   nullptr, b, l, ane_mode, out, g.M, Cout, g.K, s);
  if (dtype == kBF16)
    return run<__nv_bfloat16>(x, w, b, l, out, g, Cout, ane_mode, kc, bm, split, s);
  if (dtype == kF16) return run<__half>(x, w, b, l, out, g, Cout, ane_mode, kc, bm, split, s);
  return cudaErrorInvalidValue;
}
