// lut_eval: the 33-knot piecewise-linear activation of the engine's
// activation unit (paper §3.5), one device function shared by the act_lut
// kernel and the fused epilogues of anemm and conv2d, so that "fused" and
// "kernel, then act_lut" give the same bits by construction.
//
// The body of the Pallas TPU kernel `act_lut`
// (src/repro/kernels/act_lut/act_lut.py:27, `lut_eval`): the segment index is
// the count of knots 1..32 that x reaches, clipped to 31 (it fixes the NaN and
// edge behaviour), the segment evaluates as slope*x + intercept with the
// product and the sum rounded separately (no FMA contraction, as the
// reference computes them), past the domain the end clamps apply, and in ANE
// mode a NaN input reads as +inf and the result rounds to fp16 (the unit's
// output port).
//
// The segment index is found by a branchless five-step search,
//   idx = 0; for s = 16, 8, 4, 2, 1: idx += (x >= xs[idx + s]) ? s : 0,
// which equals the count min(#{i in 1..32 : x >= xs[i]}, 31) whenever the
// knots are non-decreasing. The host checks that of every table it hands a
// kernel (numerics.LutTable.kernel_operands), so it is the kernels' stated
// contract. Why the two agree: before the step of size s the answer lies in
// [idx, idx + 2s - 1] (for s = 16: [0, 31]). If x >= xs[idx + s], then x
// reaches every knot up to idx + s, so the answer is at least idx + s; else
// x is below xs[idx + s] and every later knot, so the answer is below
// idx + s. After s = 1 one index is left. The search never reads xs[32] and
// reaches at most 31, which is the clip; a NaN fails every compare and gets
// 0 both ways; equal knots count the same both ways. That is five reads of
// the knots and two of the segment's slope and intercept an element, where
// the count made 32 and two.
#pragma once

#include "common.cuh"

namespace repro {

// a table's operands as one fp32 array: xs (33), slopes (32), intercepts
// (32), lo clamp, hi clamp (numerics.LutTable.kernel_operands)
constexpr int kLutFloats = 99;

// the segment of x among non-decreasing knots xs[0..32]: the five-step search
__device__ __forceinline__ int lut_segment(float x, const float* xs) {
  int idx = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) idx += (x >= xs[idx + s]) ? s : 0;
  return idx;
}

// xs, sl, ic: knots, slopes, intercepts; x0, x32: the first and last knot;
// lo, hi: the end clamps
__device__ __forceinline__ float lut_eval(float x, const float* xs, const float* sl,
                                          const float* ic, float x0, float x32, float lo,
                                          float hi, bool ane) {
  if (ane && isnan(x)) x = INFINITY;
  const int idx = lut_segment(x, xs);
  float y = __fadd_rn(__fmul_rn(sl[idx], x), ic[idx]);
  if (x < x0) y = lo;
  if (x > x32) y = hi;
  if (ane) y = __half2float(__float2half_rn(y));
  return y;
}

// the same on a table in the kLutFloats layout
__device__ __forceinline__ float lut_eval(float x, const float* table, bool ane) {
  return lut_eval(x, table, table + 33, table + 65, table[0], table[32], table[97], table[98],
                  ane);
}

}  // namespace repro
