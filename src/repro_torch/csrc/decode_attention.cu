// decode_attention: one query row per sequence against a (B, S, KV, d) cache.
//
// Replaces the Pallas TPU kernel `decode_attention`
// (src/repro/kernels/flash/decode_attention.py:67, body `_kernel` at :29).
// One block owns one (batch, kv head): the g = H / KV query heads of that
// group share every K/V row it stages in shared memory, and an online
// softmax (fp32 m, l, acc) runs over 64-slot cache chunks. A slot is valid
// when pos >= 0, pos <= current and, with a window, current - pos < window;
// invalid slots score -1e30 as in the reference, so a lane whose every slot
// is invalid still gives a finite result (uniform weights over its S slots,
// the reference's softmax over -1e30). Chunk padding past S gets no weight.
//
// What bounds it on an H100: one query row per sequence does ~2 operations
// per cache element, so the kernel is bound by the bytes of the cache it
// reads (3.35 TB/s). This first version reads K and V rows as coalesced
// head-dim vectors and converts them to fp32 once per block; with only
// B * KV blocks (32 for tinyllama at 8 lanes) it cannot fill the card, and a
// split over the cache length with a second combine pass is later work.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int DA_THREADS = 128, DA_WARPS = DA_THREADS / 32, DA_BK = 64;
constexpr int DA_GMAX = 32;                    // query heads per kv head
constexpr int DA_ROWS = DA_GMAX / DA_WARPS;    // query rows per warp, at most
constexpr int DA_KPL = DA_BK / 32;             // slots per lane

template <typename T, int D>
__global__ void __launch_bounds__(DA_THREADS)
    decode_fwd(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
               const int* __restrict__ pos, const int* __restrict__ cur, T* __restrict__ out,
               int H, int KV, int S, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int DL = (D + 31) / 32;
  __shared__ float Qs[DA_GMAX][D];
  __shared__ float Ks[DA_BK][DP];
  __shared__ float Vs[DA_BK][DP];
  __shared__ int St[DA_BK];  // 1 valid, 0 masked (-1e30), -1 past the cache
  __shared__ float Ps[DA_WARPS][DA_BK];

  const int b = blockIdx.x / KV, kh = blockIdx.x % KV;
  const int g = H / KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* qb = q + ((long long)b * H + (long long)kh * g) * D;
  for (int i = tid; i < g * D; i += DA_THREADS) Qs[i / D][i % D] = to_f32(qb[i]);
  const int cur_b = cur[b];
  const int* pb = pos + (long long)b * S;

  float m[DA_ROWS], l[DA_ROWS], acc[DA_ROWS][DL];
#pragma unroll
  for (int rr = 0; rr < DA_ROWS; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.0f;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) acc[rr][dd] = 0.0f;
  }

  for (int s0 = 0; s0 < S; s0 += DA_BK) {
    __syncthreads();  // the previous chunk is consumed (and Qs is written)
    for (int i = tid; i < DA_BK * D; i += DA_THREADS) {
      const int r = i / D, c = i % D, slot = s0 + r;
      const bool in = slot < S;
      const long long off = (((long long)b * S + slot) * KV + kh) * D + c;
      Ks[r][c] = in ? to_f32(kc[off]) : 0.0f;
      Vs[r][c] = in ? to_f32(vc[off]) : 0.0f;
    }
    for (int i = tid; i < DA_BK; i += DA_THREADS) {
      const int slot = s0 + i;
      int st = -1;
      if (slot < S) {
        const int p = pb[slot];
        bool ok = p >= 0 && p <= cur_b;
        if (window > 0) ok = ok && (cur_b - p) < window;
        st = ok ? 1 : 0;
      }
      St[i] = st;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < DA_ROWS; ++rr) {
      const int r = warp + DA_WARPS * rr;
      if (r >= g) break;  // warp-uniform
      float s[DA_KPL];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < DA_KPL; ++j) {
        const int kk = lane + 32 * j;
        float dot = 0.0f;
#pragma unroll
        for (int c = 0; c < D; ++c) dot = fmaf(Qs[r][c], Ks[kk][c], dot);
        const int st = St[kk];
        const float sj = st == 1 ? dot * scale : (st == 0 ? kNegInf : -INFINITY);
        s[j] = sj;
        mx = fmaxf(mx, sj);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m[rr], mx);
      const float corr = expf(m[rr] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < DA_KPL; ++j) {
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
          for (int kk = 0; kk < DA_BK; ++kk) pv = fmaf(Ps[warp][kk], Vs[kk][c], pv);
          acc[rr][dd] = acc[rr][dd] * corr + pv;
        }
      }
      __syncwarp();
    }
  }

  T* ob = out + ((long long)b * H + (long long)kh * g) * D;
#pragma unroll
  for (int rr = 0; rr < DA_ROWS; ++rr) {
    const int r = warp + DA_WARPS * rr;
    if (r >= g) break;
    const float inv = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) {
      const int c = lane + 32 * dd;
      if (c < D) ob[r * D + c] = from_f32<T>(acc[rr][dd] / inv);
    }
  }
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const int* pos,
                     const int* cur, void* out, int B, int H, int KV, int S, int window,
                     float scale, cudaStream_t s) {
  const dim3 grid(B * KV);
  switch (D) {
#define REPRO_DECODE_CASE(DV)                                                              \
  case DV:                                                                                 \
    decode_fwd<T, DV><<<grid, DA_THREADS, 0, s>>>(                                         \
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos, \
        cur, static_cast<T*>(out), H, KV, S, window, scale);                               \
    return cudaGetLastError();
    REPRO_DECODE_CASE(16)
    REPRO_DECODE_CASE(32)
    REPRO_DECODE_CASE(64)
#undef REPRO_DECODE_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, D), k/v cache (B, S, KV, D), positions (B, S) int32, current (B,)
// int32, out (B, H, D): all contiguous. window <= 0: none. H / KV <= 32.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* positions, const void* current, void* out,
                                       int B, int H, int KV, int S, int D, int window,
                                       float scale, int dtype, void* stream) {
  if (H % KV != 0 || H / KV > DA_GMAX) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(positions);
  const int* cur = static_cast<const int*>(current);
  switch (dtype) {
    case kF32: return launch_d<float>(D, q, k, v, pos, cur, out, B, H, KV, S, window, scale, s);
    case kBF16: return launch_d<__nv_bfloat16>(D, q, k, v, pos, cur, out, B, H, KV, S, window, scale, s);
    default: return cudaErrorInvalidValue;  // fp32 and bf16: the registry row's surface
  }
}
