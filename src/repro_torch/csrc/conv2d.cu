// conv2d: direct NHWC convolution, HWIO weights, fp32 accumulation, with the
// bias / ANE saturation / fused LUT-activation epilogue at the output port.
//
// Replaces the Pallas TPU kernel `conv2d` (src/repro/kernels/conv/conv2d.py:95,
// body `_kernel` at :55). The TPU kernel keeps one padded image in VMEM and
// runs KH*KW tap matmuls, each a strided spatial slice against a (Cin, Cout)
// weight plane, into an fp32 scratch. Here the convolution is an implicit
// GEMM on the port's shared tile loop (tile_matmul.cuh): M = B*OH*OW output
// pixels, N = Cout, K = KH*KW*Cin taken tap-major and channel-minor, which is
// the HWIO weight reshaped to (KH*KW*Cin, Cout) and read as a dense B. The A
// producer below maps (m, k) to x[b, oy*sh + i - ph_lo, ox*sw + j - pw_lo, c]
// and reads zero outside the image, so the SAME pads of `pad_explicit` apply
// without padding anything in device memory; where Cin % 8 == 0 (whisper's
// 80 and 768 mel and model widths) eight channels of one tap arrive as one
// 16-byte load. The output is row-major (M, N), which is NHWC.
// Every output element sums its taps in the same K order whatever B is.
// The epilogue (epilogue.cuh) adds the bias, saturates in ANE mode and, with
// `epilogue=`, rounds to the output dtype and runs the shared lut_eval, so
// fused equals conv-then-act_lut bit for bit.
//
// What bounds it on an H100: whisper-small's stem convs are short and wide
// (K = 240 or 2304, N = 768, M = 1500 or 3000 per request); in bf16 the
// wider one is bound by tensor-core operations (5.3 GFLOP, 5.4 us at
// 989 TFLOP/s), the narrower by its bytes. This first version inherits the
// tile loop's WMMA without cp.async/TMA pipelining and decodes (m, k) with
// integer divisions per 16-byte chunk, so it sits well below that bound.
#include "epilogue.cuh"

namespace {

using namespace repro;

// A (M, K) gathered from an NHWC image: the implicit-GEMM operand
template <typename T>
struct ConvA {
  const T* __restrict__ x;  // (B, H, W, Cin)
  int H, W, Cin, OH, OW, KW, SH, SW, PH, PW;  // PH, PW: the low-side pads
  int M, K;                                   // B*OH*OW, KH*KW*Cin
  int vec;                                    // Cin % 8 == 0 and x 16-byte aligned

  // x's element that A(m, k) reads, or -1 where it reads a zero pad
  __device__ __forceinline__ long long offset(int m, int k) const {
    if (m >= M || k >= K) return -1;
    const int ox = m % OW, t = m / OW;
    const int oy = t % OH, b = t / OH;
    const int c = k % Cin, tap = k / Cin;
    const int iy = oy * SH + tap / KW - PH, ix = ox * SW + tap % KW - PW;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) return -1;
    return ((static_cast<long long>(b) * H + iy) * W + ix) * Cin + c;
  }

  template <int ROWS, int COLS, int LDA, int THREADS>
  __device__ void load(T* __restrict__ dst, int m0, int k0) const {
    constexpr int V = tile::H_VEC;
    constexpr int CPR = COLS / V;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * V;
      T* d = dst + r * LDA + c;
      if (vec) {  // the chunk's 8 channels lie in one tap (Cin % 8 == 0)
        const long long off = offset(m0 + r, k0 + c);
        *reinterpret_cast<uint4*>(d) =
            off >= 0 ? *reinterpret_cast<const uint4*>(x + off) : make_uint4(0, 0, 0, 0);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const long long off = offset(m0 + r, k0 + c + e);
          d[e] = off >= 0 ? x[off] : from_f32<T>(0.0f);
        }
      }
    }
  }

  __device__ __forceinline__ float at(int m, int k) const {
    const long long off = offset(m, k);
    return off >= 0 ? to_f32<T>(x[off]) : 0.0f;
  }
};

template <typename T>
int run(const void* x, const void* w, const float* bias, const float* lut, void* out, int B,
        int H, int W, int Cin, int Cout, int KH, int KW, int SH, int SW, int PH, int PW, int OH,
        int OW, int ane_mode, cudaStream_t s) {
  const int M = B * OH * OW, K = KH * KW * Cin;
  const int vec = (Cin % tile::H_VEC == 0) && (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  const ConvA<T> ap{static_cast<const T*>(x), H, W, Cin, OH, OW, KW, SH, SW, PH, PW, M, K, vec};
  return launch_ane<T>(ap, tile::dense_b<T>(w, K, Cout), nullptr, bias, lut, ane_mode, out, M,
                       Cout, K, s);
}

}  // namespace

// x (B, H, W, Cin) NHWC, w (KH, KW, Cin, Cout) HWIO, out (B, OH, OW, Cout):
// contiguous, one dtype (code). bias: (Cout,) fp32 or null; lut: the fused
// activation's kLutFloats table or null. PH, PW: the low-side explicit pads.
extern "C" int conv2d_launch(const void* x, const void* w, const void* bias, const void* lut,
                             void* out, int B, int H, int W, int Cin, int Cout, int KH, int KW,
                             int SH, int SW, int PH, int PW, int OH, int OW, int dtype,
                             int ane_mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const float*>(bias);
  const auto* l = static_cast<const float*>(lut);
  if (dtype == kF32)
    return run<float>(x, w, b, l, out, B, H, W, Cin, Cout, KH, KW, SH, SW, PH, PW, OH, OW,
                      ane_mode, s);
  if (dtype == kBF16)
    return run<__nv_bfloat16>(x, w, b, l, out, B, H, W, Cin, Cout, KH, KW, SH, SW, PH, PW, OH,
                              OW, ane_mode, s);
  if (dtype == kF16)
    return run<__half>(x, w, b, l, out, B, H, W, Cin, Cout, KH, KW, SH, SW, PH, PW, OH, OW,
                       ane_mode, s);
  return cudaErrorInvalidValue;
}
