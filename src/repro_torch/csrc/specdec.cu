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
// (8, 5, 32000) verify window of tinyllama, 1.5 us). Two passes from one C
// entry point:
//   * `slice_argmax`, grid (rows, n_slice): the wrapper's plan
//     (`slice_plan(V)` in kernels/specdec/specdec.py) cuts every row into
//     n_slice slices of slice_cols columns, from V alone; slice_cols is a
//     multiple of 4, so each slice of a 16-byte aligned row starts on a
//     16-byte boundary. A block of 256 threads reduces its slice to one
//     (value, index) pair with 16-byte loads, four in flight a thread (where
//     rows are 16-byte aligned and V % 4 == 0; else scalar loads), and writes
//     it to the int32 workspace (the value's bits, then the index). The 40
//     rows of tinyllama's window make 320 blocks, where one block a lane
//     used 8 of 132 SMs.
//   * `accept`, one warp a lane: merges each row's n_slice pairs, takes the
//     accept prefix of each branch and the first longest one, and writes
//     samples, accept and branch.
// `better` is a total order on (value, index) pairs, so every merge, in any
// order, gives the plain version's ints exactly.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int SD_THREADS = 256, SD_WARPS = SD_THREADS / 32, SD_UNROLL = 4;

// does (v, i) come before (bv, bi) in torch.argmax's order?
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void take(float v, int i, float& bv, int& bi) {
  if (better(v, i, bv, bi)) {
    bv = v;
    bi = i;
  }
}

// Block (row, slice): the first-index argmax of columns [c0, min(vocab, c0 +
// slice_cols)) of the row into ws[2·(row·n_slice + slice) + {0, 1}]. Starts
// from (-inf, INT_MAX), so the first -inf a thread sees still replaces it; a
// slice wholly past vocab leaves (-inf, INT_MAX), which never wins.
__global__ void __launch_bounds__(SD_THREADS)
    slice_argmax(const float* __restrict__ scores, int* __restrict__ ws, int V, int vocab,
                 int slice_cols, bool vec) {
  const long long row = blockIdx.x;
  const int slice = blockIdx.y, n_slice = gridDim.y;
  const int c0 = slice * slice_cols, c1 = min(vocab, c0 + slice_cols);
  const float* rp = scores + row * V;
  float bv = -INFINITY;
  int bi = INT_MAX;
  if (vec) {
    const float4* r4 = reinterpret_cast<const float4*>(rp + c0);
    const int n4 = (c1 - c0 + 3) / 4;
    for (int u0 = threadIdx.x; u0 < n4; u0 += SD_THREADS * SD_UNROLL) {
      float4 x[SD_UNROLL];
#pragma unroll
      for (int u = 0; u < SD_UNROLL; ++u) {
        const int c = u0 + u * SD_THREADS;
        if (c < n4) x[u] = r4[c];
      }
#pragma unroll
      for (int u = 0; u < SD_UNROLL; ++u) {
        const int c = u0 + u * SD_THREADS;
        const float xs[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = c0 + 4 * c + j;
          if (c < n4 && i < c1) take(xs[j], i, bv, bi);
        }
      }
    }
  } else {
    for (int i = c0 + threadIdx.x; i < c1; i += SD_THREADS) take(rp[i], i, bv, bi);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    take(__shfl_xor_sync(0xffffffffu, bv, o), __shfl_xor_sync(0xffffffffu, bi, o), bv, bi);
  __shared__ float s_val[SD_WARPS];
  __shared__ int s_idx[SD_WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_val[warp] = bv;
    s_idx[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < SD_WARPS; ++w) take(s_val[w], s_idx[w], bv, bi);
    int* o = ws + 2 * (row * n_slice + slice);
    o[0] = __float_as_int(bv);
    o[1] = bi;
  }
}

// Block b (one warp): scores' pairs ws (B, NBR, T, n_slice) -> picks (NBR·T
// ints, dynamic shared memory); draft (B, NBR, T-1) -> samples (B, T),
// accept (B,), branch (B,) (branch may be null: the chain).
__global__ void __launch_bounds__(32)
    accept(const int* __restrict__ ws, const int* __restrict__ draft, int* __restrict__ samples,
           int* __restrict__ accept_len, int* __restrict__ branch, int NBR, int T,
           int n_slice) {
  extern __shared__ int picks[];
  const int b = blockIdx.x, lane = threadIdx.x, R = NBR * T;
  for (int r = lane; r < R; r += 32) {
    const int* p = ws + 2 * ((long long)b * R + r) * n_slice;
    float bv = __int_as_float(p[0]);
    int bi = p[1];
    for (int s = 1; s < n_slice; ++s) take(__int_as_float(p[2 * s]), p[2 * s + 1], bv, bi);
    picks[r] = bi;
  }
  __syncwarp();
  int win = 0;
  if (lane == 0) {
    // accept prefix per branch; the first branch with the longest wins
    const int* d = draft + (long long)b * NBR * (T - 1);  // never read when T == 1
    int best = -1;
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
    accept_len[b] = best;
    if (branch != nullptr) branch[b] = win;
  }
  win = __shfl_sync(0xffffffffu, win, 0);
  for (int t = lane; t < T; t += 32) samples[(long long)b * T + t] = picks[win * T + t];
}

cudaError_t launch(const void* scores, const void* draft, void* samples, void* accept_len,
                   void* branch, int B, int NBR, int T, int V, int vocab, void* ws, int n_slice,
                   int slice_cols, void* stream) {
  if (B < 0 || NBR < 1 || T < 1 || V < 1 || vocab < 1 || vocab > V) return cudaErrorInvalidValue;
  if (n_slice < 1 || n_slice > 65535 || slice_cols < 4 || slice_cols % 4 != 0 ||
      (long long)(n_slice - 1) * slice_cols >= V || (long long)n_slice * slice_cols < V)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  if (ws == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = V % 4 == 0 && reinterpret_cast<uintptr_t>(scores) % 16 == 0;
  slice_argmax<<<dim3((unsigned)B * NBR * T, n_slice), SD_THREADS, 0, s>>>(
      static_cast<const float*>(scores), static_cast<int*>(ws), V, vocab, slice_cols, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  accept<<<B, 32, sizeof(int) * (size_t)NBR * T, s>>>(
      static_cast<const int*>(ws), static_cast<const int*>(draft), static_cast<int*>(samples),
      static_cast<int*>(accept_len), static_cast<int*>(branch), NBR, T, n_slice);
  return cudaGetLastError();
}

}  // namespace

// scores (B, T, V) fp32, draft (B, T-1) int32 (unused when T == 1),
// samples (B, T) int32, accept (B,) int32: all contiguous. 1 <= vocab <= V.
// The plan (`slice_plan(V)`): n_slice slices of slice_cols columns (a
// multiple of 4) cover [0, V), none past it; ws holds 2·B·T·n_slice int32.
extern "C" int specdec_launch(const void* scores, const void* draft, void* samples,
                              void* accept, int B, int T, int V, int vocab, void* ws,
                              int n_slice, int slice_cols, void* stream) {
  return launch(scores, draft, samples, accept, nullptr, B, 1, T, V, vocab, ws, n_slice,
                slice_cols, stream);
}

// scores (B, NBR, T, V) fp32, draft (B, NBR, T-1) int32, samples (B, T),
// accept (B,), branch (B,) int32: all contiguous. 1 <= vocab <= V. The plan
// as for specdec_launch; ws holds 2·B·NBR·T·n_slice int32.
extern "C" int specdec_tree_launch(const void* scores, const void* draft, void* samples,
                                   void* accept, void* branch, int B, int NBR, int T, int V,
                                   int vocab, void* ws, int n_slice, int slice_cols,
                                   void* stream) {
  return launch(scores, draft, samples, accept, branch, B, NBR, T, V, vocab, ws, n_slice,
                slice_cols, stream);
}
