// The kernel body of decode_attention and paged_decode_attention: one query
// row per sequence against a KV cache.
//
// Replaces the Pallas TPU kernels `decode_attention`
// (src/repro/kernels/flash/decode_attention.py:67, body `_kernel` at :29) and
// `paged_decode_attention` (:200, body `_paged_kernel` at :149). One block
// owns one (batch, kv head): the g = H / KV query heads of that group share
// every K/V row it stages in shared memory, and an online softmax (fp32 m, l,
// acc) runs over BK-slot cache chunks. A slot is valid when pos >= 0,
// pos <= current and, with a window, current - pos < window; invalid slots
// score -1e30 as in the reference, so a lane whose every slot is invalid
// still gives a finite result (uniform weights over its slots, the
// reference's softmax over -1e30). Chunk padding past the cache gets no
// weight (-inf).
//
// The body is templated on the chunk size BK and on a chunk -> rows map, and
// two sources instantiate it, each built by its own nvcc so that the two
// compile side by side (decode_attention.cu, paged_decode_attention.cu):
//   * MonoRows: a (B, S, KV, d) cache, slot s of lane b at ((b·S + s)·KV)·d;
//   * PagedRows: a shared (N, bs, KV, d) arena read through a (B, nb) block
//     table with BK = bs, so a chunk is one page: slot s of lane b in arena
//     block t = table[b, s / bs] at t·block_stride + (s % bs)·KV·d; t = -1
//     is an unmapped page: its slots are masked (-1e30, as the reference's
//     `mapped`), and the row index is clamped to 0 before any load (the
//     reference's `jnp.maximum(t, 0)`).
// With BK = bs both walk the same slots in the same order through the same
// arithmetic, so paged_decode_attention equals decode_attention(bk=bs) on
// the gathered pages bit for bit (the reference's contract). With BK < 32
// the lanes past BK own no slot: they score -inf, add nothing to the max or
// the sum, and the warp reductions keep their order.
//
// What bounds it on an H100: one query row per sequence does ~2 operations
// per cache element, so the kernel is bound by the bytes of the cache it
// reads (3.35 TB/s). This version reads K and V rows as coalesced head-dim
// vectors and converts them to fp32 once per block; with only B * KV blocks
// (32 for tinyllama at 8 lanes) it cannot fill the card, and a split over the
// cache length with a second combine pass is later work.
//
// Head dims 16, 32, 64, 128 and 256. The fp32 arrays live in dynamic shared
// memory sized per (D, BK) (`smem_bytes`): at d 128 they take 83 KB and at
// d 256 165 KB, past the 48 KB of a static allocation, so each instance asks
// for its size once per device before its first launch. The arithmetic and
// its order do not depend on where the arrays live: d <= 64 keeps its bits.
#pragma once

#include "common.cuh"

namespace repro {
namespace decode {

constexpr int DA_THREADS = 128, DA_WARPS = DA_THREADS / 32, DA_BKMAX = 64;
constexpr int DA_GMAX = 32;                    // query heads per kv head
constexpr int DA_ROWS = DA_GMAX / DA_WARPS;    // query rows per warp, at most

// A chunk of BK consecutive slots of one lane is BK consecutive cache rows in
// both layouts: a Rows functor gives the chunk's first row (its element
// offset, before the kv head) and its positions, once per chunk.
struct Chunk {
  long long base;   // element offset of the chunk's first slot, head 0
  const int* pos;   // the chunk's positions
  bool mapped;      // false: an unmapped page, every slot masked
};

// (B, S, KV, D) cache, positions (B, S)
struct MonoRows {
  const int* pos;
  int S, KV;
  __device__ __forceinline__ int length() const { return S; }
  __device__ __forceinline__ Chunk chunk(int b, int s0, int D) const {
    const long long slot = (long long)b * S + s0;
    return {slot * KV * D, pos + slot, true};
  }
};

// (N, bs, KV, D) arena rows `block_stride` elements apart, positions (N, bs)
// `pos_stride` apart, block table (B, nb); the chunk is one page (BK == bs)
struct PagedRows {
  const int* pos;
  const int* table;
  long long block_stride, pos_stride;
  int bs, nb;
  __device__ __forceinline__ int length() const { return nb * bs; }
  __device__ __forceinline__ Chunk chunk(int b, int s0, int) const {
    const int t = table[(long long)b * nb + s0 / bs];
    const long long row = max(t, 0);   // an unmapped page reads row 0
    return {row * block_stride, pos + row * pos_stride, t >= 0};
  }
};

// The body, on the block's shared arrays. They are carved from one dynamic
// allocation (decode_fwd), and each comes in as its own __restrict__
// pointer, so the compiler still knows that no two of them overlap (writes
// to Ps do not force reloads of Qs, Ks or Vs).
template <typename T, int D, int BK, typename Rows>
__device__ __forceinline__ void decode_body(
    const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
    const Rows& rows, const int* __restrict__ cur, T* __restrict__ out, int H, int KV,
    int window, float scale, float (*__restrict__ Qs)[D], float (*__restrict__ Ks)[D + 1],
    float (*__restrict__ Vs)[D + 1], float (*__restrict__ Ps)[BK],
    int* __restrict__ St /* 1 valid, 0 masked (-1e30), -1 past the cache */) {
  constexpr int DL = (D + 31) / 32;
  constexpr int KPL = (BK + 31) / 32;          // slots per lane
  // the dot product's loop is unrolled in full up to d 64; wider heads
  // unroll by 32 (the same sums in the same order, in less code)
  constexpr int DOT_UNROLL = D <= 64 ? D : 32;
  const int b = blockIdx.x / KV, kh = blockIdx.x % KV;
  const int g = H / KV;
  const int S = rows.length();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* qb = q + ((long long)b * H + (long long)kh * g) * D;
  for (int i = tid; i < g * D; i += DA_THREADS) Qs[i / D][i % D] = to_f32(qb[i]);
  const int cur_b = cur[b];

  float m[DA_ROWS], l[DA_ROWS], acc[DA_ROWS][DL];
#pragma unroll
  for (int rr = 0; rr < DA_ROWS; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.0f;
#pragma unroll
    for (int dd = 0; dd < DL; ++dd) acc[rr][dd] = 0.0f;
  }

  for (int s0 = 0; s0 < S; s0 += BK) {
    __syncthreads();  // the previous chunk is consumed (and Qs is written)
    const Chunk ch = rows.chunk(b, s0, D);
    for (int i = tid; i < BK * D; i += DA_THREADS) {
      const int r = i / D, c = i % D;
      const bool in = s0 + r < S;
      const long long off = ch.base + ((long long)r * KV + kh) * D + c;
      Ks[r][c] = in ? to_f32(kc[off]) : 0.0f;
      Vs[r][c] = in ? to_f32(vc[off]) : 0.0f;
    }
    for (int i = tid; i < BK; i += DA_THREADS) {
      int st = -1;
      if (s0 + i < S) {
        const int p = ch.pos[i];
        bool ok = ch.mapped && p >= 0 && p <= cur_b;
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
      float s[KPL];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int kk = lane + 32 * j;
        float sj = -INFINITY;  // a lane past the chunk owns no slot
        if (kk < BK) {
          float dot = 0.0f;
#pragma unroll (DOT_UNROLL)
          for (int c = 0; c < D; ++c) dot = fmaf(Qs[r][c], Ks[kk][c], dot);
          const int st = St[kk];
          sj = st == 1 ? dot * scale : (st == 0 ? kNegInf : -INFINITY);
        }
        s[j] = sj;
        mx = fmaxf(mx, sj);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m[rr], mx);
      const float corr = expf(m[rr] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int kk = lane + 32 * j;
        const float p = expf(s[j] - m_new);
        if (kk < BK) Ps[warp][kk] = p;
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
          for (int kk = 0; kk < BK; ++kk) pv = fmaf(Ps[warp][kk], Vs[kk][c], pv);
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


// shared memory of decode_fwd<T, D, BK>: Qs [DA_GMAX][D], Ks and Vs [BK][D + 1],
// Ps [DA_WARPS][BK] (fp32), St [BK] (int)
template <int D, int BK>
constexpr int smem_bytes() {
  return (DA_GMAX * D + 2 * BK * (D + 1) + DA_WARPS * BK) * 4 + BK * 4;
}

template <typename T, int D, int BK, typename Rows>
__global__ void __launch_bounds__(DA_THREADS)
    decode_fwd(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
               const Rows rows, const int* __restrict__ cur, T* __restrict__ out, int H,
               int KV, int window, float scale) {
  extern __shared__ __align__(16) unsigned char da_smem[];
  float* f = reinterpret_cast<float*>(da_smem);
  float* ks = f + DA_GMAX * D;
  float* vs = ks + BK * (D + 1);
  float* ps = vs + BK * (D + 1);
  decode_body<T, D, BK>(q, kc, vc, rows, cur, out, H, KV, window, scale,
                        reinterpret_cast<float(*)[D]>(f), reinterpret_cast<float(*)[D + 1]>(ks),
                        reinterpret_cast<float(*)[D + 1]>(vs), reinterpret_cast<float(*)[BK]>(ps),
                        reinterpret_cast<int*>(ps + DA_WARPS * BK));
}

template <typename T, int D, int BK, typename Rows>
cudaError_t launch_one(const void* q, const void* k, const void* v, const Rows& rows,
                       const int* cur, void* out, int B, int H, int KV, int window,
                       float scale, cudaStream_t s) {
  constexpr int smem = smem_bytes<D, BK>();
  static bool ready[kMaxDevices] = {};
  const cudaError_t err = allow_dynamic_smem(decode_fwd<T, D, BK, Rows>, smem, ready);
  if (err != cudaSuccess) return err;
  decode_fwd<T, D, BK, Rows><<<dim3(B * KV), DA_THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), rows, cur,
      static_cast<T*>(out), H, KV, window, scale);
  return cudaGetLastError();
}

template <typename T, int D, typename Rows>
cudaError_t launch_bk(int BK, const void* q, const void* k, const void* v, const Rows& rows,
                      const int* cur, void* out, int B, int H, int KV, int window,
                      float scale, cudaStream_t s) {
  switch (BK) {
    case 8: return launch_one<T, D, 8>(q, k, v, rows, cur, out, B, H, KV, window, scale, s);
    case 16: return launch_one<T, D, 16>(q, k, v, rows, cur, out, B, H, KV, window, scale, s);
    case DA_BKMAX:
      return launch_one<T, D, DA_BKMAX>(q, k, v, rows, cur, out, B, H, KV, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename Rows>
cudaError_t launch_d(int D, int BK, const void* q, const void* k, const void* v,
                     const Rows& rows, const int* cur, void* out, int B, int H, int KV,
                     int window, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch_bk<T, 16>(BK, q, k, v, rows, cur, out, B, H, KV, window, scale, s);
    case 32: return launch_bk<T, 32>(BK, q, k, v, rows, cur, out, B, H, KV, window, scale, s);
    case 64: return launch_bk<T, 64>(BK, q, k, v, rows, cur, out, B, H, KV, window, scale, s);
    case 128: return launch_bk<T, 128>(BK, q, k, v, rows, cur, out, B, H, KV, window, scale, s);
    case 256: return launch_bk<T, 256>(BK, q, k, v, rows, cur, out, B, H, KV, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Rows>
int launch_dtype(int dtype, int D, int BK, const void* q, const void* k, const void* v,
                 const Rows& rows, const void* current, void* out, int B, int H, int KV,
                 int window, float scale, void* stream) {
  if (KV < 1 || H % KV != 0 || H / KV > DA_GMAX) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cur = static_cast<const int*>(current);
  switch (dtype) {
    case kF32:
      return launch_d<float>(D, BK, q, k, v, rows, cur, out, B, H, KV, window, scale, s);
    case kBF16:
      return launch_d<__nv_bfloat16>(D, BK, q, k, v, rows, cur, out, B, H, KV, window, scale,
                                     s);
    default: return cudaErrorInvalidValue;  // fp32 and bf16: the registry rows' surface
  }
}

}  // namespace decode
}  // namespace repro
