// The output-port epilogue of the port's matmul and conv kernels, applied to
// each fp32 accumulator before the one store that rounds to the activation's
// dtype T, in the reference's order (src/repro/kernels/anemm/anemm.py:43-61,
// src/repro/kernels/conv/conv2d.py:75-88): per-N scale, bias, ANE-mode
// saturation (|acc| >= 2^15 -> +-inf), then, with a LUT, the activation unit:
// round to T (the store of the separate-op pipeline), widen, lut_eval in ANE
// mode. __fmul_rn/__fadd_rn keep each step separately rounded (no FMA
// contraction), so the fused result equals kernel-then-act_lut bit for bit.
// The LUT is a template switch: without it the epilogue compiles as before.
#pragma once

#include "lut_eval.cuh"
#include "tile_matmul.cuh"

namespace repro {

constexpr float kAccumCeiling = 32768.0f;  // hal.ACCUM_OUT_CEILING (2^15)

template <typename T, bool LUT>
struct AneEpilogue {
  const float* __restrict__ scale;  // (N,) or null
  const float* __restrict__ bias;   // (N,) or null
  const float* __restrict__ lut;    // kLutFloats table (LUT only)
  int ane_mode;

  __device__ float operator()(float acc, int n) const {
    if (scale != nullptr) acc = __fmul_rn(acc, scale[n]);
    if (bias != nullptr) acc = __fadd_rn(acc, bias[n]);
    if (ane_mode) {
      if (acc >= kAccumCeiling) acc = INFINITY;
      if (acc <= -kAccumCeiling) acc = -INFINITY;
    }
    if constexpr (LUT) acc = lut_eval(to_f32<T>(from_f32<T>(acc)), lut, true);
    return acc;
  }
};

// Launch the tile loop for A producer `ap` and B producer `prod` with the
// ANE epilogue (the LUT variant when `lut` is not null) in dtype T.
template <typename T, typename AP, typename P>
int launch_ane(const AP& ap, const P& prod, const float* scale, const float* bias,
               const float* lut, int ane_mode, void* out, int M, int N, int K,
               cudaStream_t s) {
  auto run = [&](const auto& epi) {
    if constexpr (std::is_same_v<T, float>)
      return tile::launch_f32(ap, prod, epi, out, M, N, K, s);
    else
      return tile::launch_mma<T>(ap, prod, epi, out, M, N, K, s);
  };
  if (lut != nullptr) return run(AneEpilogue<T, true>{scale, bias, lut, ane_mode});
  return run(AneEpilogue<T, false>{scale, bias, nullptr, ane_mode});
}

}  // namespace repro
