// flash_attention: causal / sliding-window GQA attention with an online softmax.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash/flash_attention.py:93, body `_kernel` at :31).
// The TPU kernel walks a sequential KV grid axis with m/l/acc in VMEM
// scratch; here one block owns one (batch*head, 32-row query tile) and loops
// over 64-key KV tiles itself. Query head h reads kv head h / (H / KVH) by
// index: KV is never copied per query head. Scores, the running max m, the
// denominator l and the accumulator are fp32; masked scores are -1e30 (not
// -inf, as in the reference), keys past the sequence get no weight, and the
// output is acc / max(l, 1e-30), rounded once to the input dtype. KV tiles
// that the causal or window mask hides from every row of the block are
// skipped.
//
// What bounds it on an H100: at prefill lengths (hundreds of tokens, d = 64)
// attention does ~2*d operations per key byte, so it is bound by operations
// rather than bytes. This first version computes in fp32 on the CUDA cores
// (one warp per query row, lanes across keys for the scores and across head
// dims for P.V, K/V tiles staged in padded shared memory to avoid bank
// conflicts); tensor cores (mma/wgmma on bf16 tiles) are later work.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int FA_BQ = 32, FA_BK = 64, FA_THREADS = 256;
constexpr int FA_WARPS = FA_THREADS / 32;
constexpr int FA_ROWS = FA_BQ / FA_WARPS;  // query rows per warp
constexpr int FA_KPL = FA_BK / 32;         // keys per lane

struct Strides {  // element strides of a (B, heads, S, d) view; d is unit-stride
  long long b, h, s;
};

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ out, int H, int KVH, int Sq, int Skv, Strides qs, Strides ks,
              Strides vs, int causal, int window, float scale) {
  constexpr int DP = D + 1;  // padded row: lanes reading different keys hit different banks
  constexpr int DL = (D + 31) / 32;
  __shared__ float Qs[FA_BQ][D];
  __shared__ float Ks[FA_BK][DP];
  __shared__ float Vs[FA_BK][DP];
  __shared__ float Ps[FA_WARPS][FA_BK];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kh = h / (H / KVH);
  const int q0 = blockIdx.y * FA_BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  for (int i = tid; i < FA_BQ * D; i += FA_THREADS) {
    const int r = i / D, c = i % D, qi = q0 + r;
    Qs[r][c] = qi < Sq ? to_f32(qb[qi * qs.s + c]) : 0.0f;
  }

  float m[FA_ROWS], l[FA_ROWS], acc[FA_ROWS][DL];
#pragma unroll
  for (int rr = 0; rr < FA_ROWS; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.0f;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) acc[rr][dd] = 0.0f;
  }

  // KV range some row of this block may attend to: tiles outside it are
  // fully masked for every row and are skipped
  const int q_last = min(q0 + FA_BQ, Sq) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / FA_BK) * FA_BK;

  for (int k0 = k_begin; k0 < k_end; k0 += FA_BK) {
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    for (int i = tid; i < FA_BK * D; i += FA_THREADS) {
      const int r = i / D, c = i % D, kj = k0 + r;
      const bool in = kj < Skv;
      Ks[r][c] = in ? to_f32(kb[kj * ks.s + c]) : 0.0f;
      Vs[r][c] = in ? to_f32(vb[kj * vs.s + c]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < FA_ROWS; ++rr) {
      const int r = warp * FA_ROWS + rr;
      const int qi = q0 + r;
      float s[FA_KPL];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < FA_KPL; ++j) {
        const int kk = lane + 32 * j, kj = k0 + kk;
        float dot = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) dot = fmaf(Qs[r][c], Ks[kk][c], dot);
        float sj = dot * scale;
        bool allow = true;
        if (causal) allow = kj <= qi;
        if (window > 0) allow = allow && (qi - kj) < window;
        if (kj >= Skv) {
          sj = -INFINITY;  // past the sequence: exp() gives exactly 0
        } else if (!allow) {
          sj = kNegInf;
        }
        s[j] = sj;
        mx = fmaxf(mx, sj);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m[rr], mx);
      const float corr = expf(m[rr] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < FA_KPL; ++j) {
        const float p = expf(s[j] - m_new);
        Ps[warp][lane + 32 * j] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      l[rr] = l[rr] * corr + psum;
      m[rr] = m_new;
      __syncwarp();
#pragma unroll
      for (int dd = 0; dd < DL; ++dd) {
        const int c = lane + 32 * dd;
        if (c < D) {
          float pv = 0.0f;
#pragma unroll 8
          for (int kk = 0; kk < FA_BK; ++kk) pv = fmaf(Ps[warp][kk], Vs[kk][c], pv);
          acc[rr][dd] = acc[rr][dd] * corr + pv;
        }
      }
      __syncwarp();
    }
  }

  T* ob = out + ((long long)b * H + h) * Sq * D;
#pragma unroll
  for (int rr = 0; rr < FA_ROWS; ++rr) {
    const int qi = q0 + warp * FA_ROWS + rr;
    if (qi >= Sq) continue;
    const float inv = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) {
      const int c = lane + 32 * dd;
      if (c < D) ob[(long long)qi * D + c] = from_f32<T>(acc[rr][dd] / inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int H, int KVH,
                   int Sq, int Skv, Strides qs, Strides ks, Strides vs, int causal, int window,
                   float scale, cudaStream_t s) {
  dim3 grid(B * H, (Sq + FA_BQ - 1) / FA_BQ);
  flash_fwd<T, D><<<grid, FA_THREADS, 0, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                              static_cast<const T*>(v), static_cast<T*>(out), H,
                                              KVH, Sq, Skv, qs, ks, vs, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* out, int B, int H,
                     int KVH, int Sq, int Skv, Strides qs, Strides ks, Strides vs, int causal,
                     int window, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, H, KVH, Sq, Skv, qs, ks, vs, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, B, H, KVH, Sq, Skv, qs, ks, vs, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, H, KVH, Sq, Skv, qs, ks, vs, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, D), k/v (B, KVH, Skv, D) with the given element strides and a
// unit-stride last dim; out (B, H, Sq, D) contiguous. window <= 0: none.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int H, int KVH, int Sq, int Skv, int D,
                                      long long qsb, long long qsh, long long qss,
                                      long long ksb, long long ksh, long long kss,
                                      long long vsb, long long vsh, long long vss, int causal,
                                      int window, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  switch (dtype) {
    case kF32: return launch_d<float>(D, q, k, v, out, B, H, KVH, Sq, Skv, qs, ks, vs, causal, window, scale, s);
    case kBF16: return launch_d<__nv_bfloat16>(D, q, k, v, out, B, H, KVH, Sq, Skv, qs, ks, vs, causal, window, scale, s);
    case kF16: return launch_d<__half>(D, q, k, v, out, B, H, KVH, Sq, Skv, qs, ks, vs, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
