// anemm: (M, K) x (K, N) with an fp32 accumulator and the ANE-mode epilogue.
//
// Replaces the Pallas TPU kernel `anemm` (src/repro/kernels/anemm/anemm.py:69,
// body `_kernel` at :32). The TPU kernel walks a sequential "arbitrary" K grid
// axis, adding each block's dot product to an fp32 accumulator in VMEM
// scratch. Here bf16 and fp16 run the streaming loop of tile_matmul.cuh: K in
// the wrapper's chunks (`chunk_plan`, a function of K, N and dtype), each
// chunk's partial from zero, the partials added in chunk order, so a row's
// bits do not depend on M; at decode the chunks of an output tile go to the
// blocks of one cluster, at prefill one block walks them all. fp32 runs the
// blocked loop (true fp32 FMA, never TF32), one block over all of K in order.
// Ragged edges are masked in the kernel (zero-filled ring stages) instead of
// padding the operands in device memory as `pad_to` does. The epilogue runs
// once, after the ordered sum, in the reference's order (epilogue.cuh):
// per-N scale, bias, ANE-mode saturation (|acc| >= 2^15 -> +-inf),
// optionally the fused LUT activation (`epilogue=`, the shared lut_eval
// after a rounding to the input dtype), then ONE rounding to the input dtype.
//
// What bounds it on an H100: the serving path calls it at two extremes. At
// decode (M = 8 lanes) the weight is read once for 8 rows, so the product is
// bound by device-memory bytes (3.35 TB/s): the weight streams through the
// loop's cp.async ring, a K chunk of 64 columns a block, so that every SM
// has several stages in flight. At prefill (M = 512 prompt tokens) it is
// bound by tensor-core operations; mma.sync from 4-warp blocks is the limit
// there (a wgmma body is later work).
#include "epilogue.cuh"

// a (M, K), b (K, N), out (M, N): row-major, contiguous, one dtype.
// scale/bias: (N,) fp32 or null. lut: the fused activation's kLutFloats
// table (lut_eval.cuh), or null for none. kc, bm, split: the streaming
// loop's plan (bf16 / fp16; fp32 takes split 1 and ignores kc and bm).
extern "C" int anemm_launch(const void* a, const void* b, const void* scale, const void* bias,
                            const void* lut, void* out, int M, int N, int K, int dtype,
                            int ane_mode, int kc, int bm, int split, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  const auto* lu = static_cast<const float*>(lut);
  auto run = [&](auto t) {
    using T = decltype(t);
    return with_ane<T>(sc, bi, lu, ane_mode, [&](const auto& epi) {
      return tile::stream::launch<T>(tile::stream::dense_x<T>(a, M, K),
                                     tile::stream::dense_w<T>(b, K, N), epi, out, M, N, K,
                                     kc, bm, split, s);
    });
  };
  if (dtype == kF32)
    return split != 1 ? cudaErrorInvalidValue
                      : launch_ane(tile::DenseA{static_cast<const float*>(a), M, K},
                                   tile::DenseB{static_cast<const float*>(b), K, N}, sc, bi,
                                   lu, ane_mode, out, M, N, K, s);
  if (dtype == kBF16) return run(__nv_bfloat16{});
  if (dtype == kF16) return run(__half{});
  return cudaErrorInvalidValue;
}
