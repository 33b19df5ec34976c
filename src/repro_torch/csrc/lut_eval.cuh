// lut_eval: the 33-knot piecewise-linear activation of the engine's
// activation unit (paper §3.5), one device function shared by the act_lut
// kernel and the fused epilogues of anemm and conv2d, so that "fused" and
// "kernel, then act_lut" give the same bits by construction.
//
// The body of the Pallas TPU kernel `act_lut`
// (src/repro/kernels/act_lut/act_lut.py:27, `lut_eval`): the segment index is
// the count of knots 1..32 that x reaches (compares, no search: it fixes the
// NaN and edge behaviour), the segment evaluates as slope*x + intercept with
// the product and the sum rounded separately (no FMA contraction, as the
// reference computes them), past the domain the end clamps apply, and in ANE
// mode a NaN input reads as +inf and the result rounds to fp16 (the unit's
// output port).
#pragma once

#include "common.cuh"

namespace repro {

// a table's operands as one fp32 array: xs (33), slopes (32), intercepts
// (32), lo clamp, hi clamp (numerics.LutTable.kernel_operands)
constexpr int kLutFloats = 99;

__device__ __forceinline__ float lut_eval(float x, const float* xs, const float* sl,
                                          const float* ic, float lo, float hi, bool ane) {
  if (ane && isnan(x)) x = INFINITY;
  int idx = 0;
#pragma unroll
  for (int i = 1; i <= 32; ++i) idx += (x >= xs[i]) ? 1 : 0;
  idx = min(idx, 31);
  float y = __fadd_rn(__fmul_rn(sl[idx], x), ic[idx]);
  if (x < xs[0]) y = lo;
  if (x > xs[32]) y = hi;
  if (ane) y = __half2float(__float2half_rn(y));
  return y;
}

// the same on a table in the kLutFloats layout
__device__ __forceinline__ float lut_eval(float x, const float* table, bool ane) {
  return lut_eval(x, table, table + 33, table + 65, table[97], table[98], ane);
}

}  // namespace repro
