// anemm: (M, K) x (K, N) with an fp32 accumulator and the ANE-mode epilogue.
//
// Replaces the Pallas TPU kernel `anemm` (src/repro/kernels/anemm/anemm.py:69,
// body `_kernel` at :32). The TPU kernel walks a sequential "arbitrary" K grid
// axis with the fp32 accumulator in VMEM scratch; here each block owns one
// output tile and loops over K itself, so nothing carries between blocks and
// no split-K is used: every output element is summed in the same K order
// whatever M is. Ragged edges are masked in the kernel (zero-filled shared
// tiles) instead of padding the operands in device memory as `pad_to` does.
// The epilogue runs in the reference's order (epilogue.cuh): per-N scale,
// bias, ANE-mode saturation (|acc| >= 2^15 -> +-inf), optionally the fused
// LUT activation (`epilogue=`, the shared lut_eval after a rounding to the
// input dtype), then ONE rounding to the input dtype.
//
// What bounds it on an H100: the serving path calls it at two extremes. At
// decode (M = lanes, about 8) the weight matrix is read once and reused by
// only M rows, so the product is bound by device-memory bytes (3.35 TB/s);
// at prefill (M = prompt tokens) it is bound by tensor-core operations.
// It is the shared tile loop (tile_matmul.cuh) with dense A and B producers
// and the ANE epilogue: 16-bit inputs go through WMMA (mma.sync on tensor
// cores) from shared-memory tiles loaded with 16-byte vectors where aligned,
// fp32 inputs through true fp32 FMA (never TF32) with a 4x4 register
// micro-tile per thread. Neither pipelines its loads (no cp.async/TMA, no
// wgmma), so both sit well below their bound; that is later work.
#include "epilogue.cuh"

// a (M, K), b (K, N), out (M, N): row-major, contiguous, one dtype.
// scale/bias: (N,) fp32 or null. lut: the fused activation's kLutFloats
// table (lut_eval.cuh), or null for none.
extern "C" int anemm_launch(const void* a, const void* b, const void* scale, const void* bias,
                            const void* lut, void* out, int M, int N, int K, int dtype,
                            int ane_mode, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  const auto* lu = static_cast<const float*>(lut);
  if (dtype == kF32)
    return launch_ane<float>(tile::dense_a<float>(a, M, K), tile::dense_b<float>(b, K, N), sc,
                             bi, lu, ane_mode, out, M, N, K, s);
  if (dtype == kBF16)
    return launch_ane<__nv_bfloat16>(tile::dense_a<__nv_bfloat16>(a, M, K),
                                      tile::dense_b<__nv_bfloat16>(b, K, N), sc, bi, lu,
                                      ane_mode, out, M, N, K, s);
  if (dtype == kF16)
    return launch_ane<__half>(tile::dense_a<__half>(a, M, K), tile::dense_b<__half>(b, K, N),
                              sc, bi, lu, ane_mode, out, M, N, K, s);
  return cudaErrorInvalidValue;
}
