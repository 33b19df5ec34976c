// avg_pool / max_pool: NHWC window reductions.
//
// Replaces the Pallas TPU kernel `_pool_kernel` (src/repro/kernels/conv/pool.py:27,
// `pallas_call` in `_pool` at :44, entry points `avg_pool` :73 and
// `max_pool` :82). The TPU kernel keeps one padded image in VMEM and folds
// KH*KW strided tap slices. Here one thread computes one output (b, oy, ox, c),
// c fastest, so a warp's loads of one tap are coalesced: the taps in (i, j)
// order, each widened to fp32, out-of-range taps read as the reduction's
// identity (0 for avg, the engine's count-include-pad; -inf for max), so the
// SAME pads of `pad_explicit` apply without padding in device memory. avg
// multiplies the fp32 sum by the fp32 constant 1/(wh*ww) passed from the host
// (the reference multiplies, it does not divide); max propagates NaN as
// jnp.maximum does (fmaxf would drop it). One store in x's dtype.
//
// What bounds it on an H100: device-memory bytes (each input read once, each
// output written once, at 3.35 TB/s); a window of wh*ww taps is that many
// operations per output, below the fp32 rate. Overlapping windows re-read
// their taps through L1/L2, not device memory.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;

// NaN-propagating max: a NaN on either side wins (jnp.maximum's rule)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

template <typename T, bool AVG>
__global__ void __launch_bounds__(kThreads)
    pool_kernel(const T* __restrict__ x, T* __restrict__ y, int B, int H, int W, int C, int OH,
                int OW, int WH, int WW, int SH, int SW, int PH, int PW, float inv) {
  const long long total = static_cast<long long>(B) * OH * OW * C;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long o = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; o < total;
       o += stride) {
    const int c = static_cast<int>(o % C);
    long long t = o / C;
    const int ox = static_cast<int>(t % OW);
    t /= OW;
    const int oy = static_cast<int>(t % OH);
    const int b = static_cast<int>(t / OH);
    float acc = 0.0f;
    for (int i = 0; i < WH; ++i) {
      const int iy = oy * SH + i - PH;
      for (int j = 0; j < WW; ++j) {
        const int ix = ox * SW + j - PW;
        const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
        const float v =
            in ? to_f32<T>(x[((static_cast<long long>(b) * H + iy) * W + ix) * C + c])
               : (AVG ? 0.0f : -INFINITY);
        if (i == 0 && j == 0) acc = v;
        else acc = AVG ? __fadd_rn(acc, v) : max_nan(acc, v);
      }
    }
    if (AVG) acc = __fmul_rn(acc, inv);
    y[o] = from_f32<T>(acc);
  }
}

template <bool AVG>
int run(const void* x, void* y, int B, int H, int W, int C, int OH, int OW, int WH, int WW,
        int SH, int SW, int PH, int PW, float inv, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(B) * OH * OW * C;
  const long long blocks = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 132 * 32 ? (blocks > 0 ? blocks : 1) : 132 * 32);
#define REPRO_POOL(T)                                                                        \
  pool_kernel<T, AVG><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<T*>(y), \
                                                B, H, W, C, OH, OW, WH, WW, SH, SW, PH, PW,  \
                                                inv)
  if (dtype == kF32) REPRO_POOL(float);
  else if (dtype == kBF16) REPRO_POOL(__nv_bfloat16);
  else if (dtype == kF16) REPRO_POOL(__half);
  else return cudaErrorInvalidValue;
#undef REPRO_POOL
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, C) NHWC, y (B, OH, OW, C): contiguous, one dtype (code); PH, PW:
// the low-side explicit pads; inv: fp32 1/(WH*WW) (avg only)
extern "C" int avg_pool_launch(const void* x, void* y, int B, int H, int W, int C, int OH, int OW,
                               int WH, int WW, int SH, int SW, int PH, int PW, float inv,
                               int dtype, void* stream) {
  return run<true>(x, y, B, H, W, C, OH, OW, WH, WW, SH, SW, PH, PW, inv, dtype, stream);
}

extern "C" int max_pool_launch(const void* x, void* y, int B, int H, int W, int C, int OH, int OW,
                               int WH, int WW, int SH, int SW, int PH, int PW, float inv,
                               int dtype, void* stream) {
  return run<false>(x, y, B, H, W, C, OH, OW, WH, WW, SH, SW, PH, PW, inv, dtype, stream);
}
