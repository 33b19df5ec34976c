// specdec: fused speculative-decoding verify/accept, chain and tree.
//
// Replaces the Pallas TPU kernels `verify_accept_kernel`
// (src/repro/kernels/specdec/specdec.py:147, body `_kernel` at :43) and
// `verify_accept_tree_kernel` (:98, body `_tree_kernel` at :67). For every
// (branch, position) row of fp32 scores the kernel takes the target's pick, a
// first-index argmax over the row's first `vocab` columns; then the accept
// prefix, the number of leading draft tokens that equal the picks at their
// positions; and, for a tree, the branch with the longest prefix (the first
// such branch on ties), whose picks it writes out. The order is torch.argmax's:
// NaN above every number, then the larger value, then the smaller index, so a
// row of all -inf picks 0, like the plain version. Columns at or past `vocab`
// never win.
//
// What bounds it on an H100: each score is read once and compared once, so the
// kernel is bound by the bytes of the scores (3.35 TB/s; 5.12 MB for the
// (8, 5, 32000) verify window of tinyllama). This first version gives one
// block to one lane: 512 threads walk each row with 16-byte loads, four in
// flight per thread (where the row is 16-byte aligned and V % 4 == 0), keep
// a per-thread (value, index) best, and reduce it across the warp and then
// across the block's warps with the index as the tie-break, never relying on
// thread order. With 8 lanes it occupies 8 of 132 SMs; a grid over rows with
// a second pass is later work (it launches once per verify window).
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int SD_THREADS = 512, SD_WARPS = SD_THREADS / 32, SD_UNROLL = 4;

// does (v, i) come before (bv, bi) in torch.argmax's order?
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

// first-index argmax of row[0:vocab], one block; the result is valid in
// thread 0 only. Starts from (-inf, INT_MAX), so the first -inf a thread
// sees still replaces it and an all -inf row picks 0.
__device__ int row_argmax(const float* __restrict__ row, int vocab, bool vec, float* s_val,
                          int* s_idx) {
  float bv = -INFINITY;
  int bi = INT_MAX;
  if (vec) {
    // SD_UNROLL independent 16-byte loads in flight per thread
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const int n4 = (vocab + 3) / 4;
    for (int c0 = threadIdx.x; c0 < n4; c0 += SD_THREADS * SD_UNROLL) {
      float4 x[SD_UNROLL];
#pragma unroll
      for (int u = 0; u < SD_UNROLL; ++u) {
        const int c = c0 + u * SD_THREADS;
        if (c < n4) x[u] = row4[c];
      }
#pragma unroll
      for (int u = 0; u < SD_UNROLL; ++u) {
        const int c = c0 + u * SD_THREADS;
        const float xs[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * c + j;
          if (c < n4 && i < vocab && better(xs[j], i, bv, bi)) {
            bv = xs[j];
            bi = i;
          }
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < vocab; i += SD_THREADS) {
      const float v = row[i];
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_val[warp] = bv;
    s_idx[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < SD_WARPS; ++w)
      if (better(s_val[w], s_idx[w], bv, bi)) {
        bv = s_val[w];
        bi = s_idx[w];
      }
  }
  __syncthreads();  // s_val / s_idx are free for the next row
  return bi;
}

// one block per lane b: scores (B, NBR, T, V), draft (B, NBR, T-1) ->
// samples (B, T), accept (B,), branch (B,) (branch may be null: the chain).
// picks (NBR * T ints) lives in dynamic shared memory.
__global__ void __launch_bounds__(SD_THREADS)
    verify_accept(const float* __restrict__ scores, const int* __restrict__ draft,
                  int* __restrict__ samples, int* __restrict__ accept, int* __restrict__ branch,
                  int NBR, int T, int V, int vocab, bool vec) {
  extern __shared__ int picks[];
  __shared__ float s_val[SD_WARPS];
  __shared__ int s_idx[SD_WARPS];
  const int b = blockIdx.x;
  const float* lane = scores + (long long)b * NBR * T * V;
  for (int r = 0; r < NBR * T; ++r) {
    const int p = row_argmax(lane + (long long)r * V, vocab, vec, s_val, s_idx);
    if (threadIdx.x == 0) picks[r] = p;
  }
  __shared__ int s_win;
  if (threadIdx.x == 0) {
    // accept prefix per branch; the first branch with the longest wins
    const int* d = draft + (long long)b * NBR * (T - 1);  // never read when T == 1
    int best = -1, win = 0;
    for (int br = 0; br < NBR; ++br) {
      int acc = 0;
      for (int i = 0; i < T - 1; ++i) {
        if (d[br * (T - 1) + i] != picks[br * T + i]) break;
        ++acc;
      }
      if (acc > best) {
        best = acc;
        win = br;
      }
    }
    accept[b] = best;
    if (branch != nullptr) branch[b] = win;
    s_win = win;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += SD_THREADS)
    samples[(long long)b * T + t] = picks[s_win * T + t];
}

cudaError_t launch(const void* scores, const void* draft, void* samples, void* accept,
                   void* branch, int B, int NBR, int T, int V, int vocab, void* stream) {
  if (B < 0 || NBR < 1 || T < 1 || V < 1 || vocab < 1 || vocab > V) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const bool vec = V % 4 == 0 && reinterpret_cast<uintptr_t>(scores) % 16 == 0;
  const size_t smem = sizeof(int) * (size_t)NBR * T;
  verify_accept<<<B, SD_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const int*>(draft),
      static_cast<int*>(samples), static_cast<int*>(accept), static_cast<int*>(branch), NBR,
      T, V, vocab, vec);
  return cudaGetLastError();
}

}  // namespace

// scores (B, T, V) fp32, draft (B, T-1) int32 (unused when T == 1),
// samples (B, T) int32, accept (B,) int32: all contiguous. 1 <= vocab <= V.
extern "C" int specdec_launch(const void* scores, const void* draft, void* samples,
                              void* accept, int B, int T, int V, int vocab, void* stream) {
  return launch(scores, draft, samples, accept, nullptr, B, 1, T, V, vocab, stream);
}

// scores (B, NBR, T, V) fp32, draft (B, NBR, T-1) int32, samples (B, T),
// accept (B,), branch (B,) int32: all contiguous. 1 <= vocab <= V.
extern "C" int specdec_tree_launch(const void* scores, const void* draft, void* samples,
                                   void* accept, void* branch, int B, int NBR, int T, int V,
                                   int vocab, void* stream) {
  return launch(scores, draft, samples, accept, branch, B, NBR, T, V, vocab, stream);
}
