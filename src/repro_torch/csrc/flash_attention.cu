// flash_attention: causal / sliding-window GQA attention with an online softmax.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash/flash_attention.py:93, body `_kernel` at :31).
// The TPU kernel walks a sequential KV grid axis with m/l/acc in VMEM
// scratch; here a block loops over KV tiles itself. What every path keeps
// from the reference: query head h reads kv head h / (H / KVH) by index (KV is
// never copied per query head); scores, the running max m (starting at
// -1e30), the denominator l and the accumulator are fp32; masked scores are
// -1e30 (not -inf), keys past the sequence -inf (no weight); KV tiles that the
// causal or window mask hides from every row of a block are skipped; the
// output is acc / max(l, 1e-30), rounded once to the input dtype.
//
// Three bodies; the wrapper (kernels/flash/flash_attention.py, `flash_plan`)
// picks the path:
//
// * bf16 / fp16, Sq above 16: `flash_tile`, the tensor-core body. A block
//   owns 64 query rows of one (batch, head), 16 per warp. S = Q·Kᵀ and
//   O += P·V run as mma.sync.m16n8k16 in the input dtype with fp32
//   accumulators, fed by ldmatrix (ldmatrix.trans for V, whose rows are
//   keys). K and V tiles (64 keys up to d 128, 32 at d 256) stream through a
//   two-stage ring of 16-byte cp.async copies into rows padded by 16 bytes
//   (ldmatrix reads 8 rows at once; the pad puts them on distinct banks), so
//   the next tile's copy is in flight while this one computes. The online
//   softmax stays in the accumulator's register layout: a thread holds two
//   rows, reduced across the 4 threads of its quad. Scores are scaled by
//   scale·log2(e), so each exp is one ex2.approx (m and l are the same
//   quantities in that unit). P is rounded to the input dtype for the P·V
//   product, since mma takes no fp32 operand: against the reference's fp32
//   P·V that adds one relative rounding of at most 2^-8 (bf16) per weight,
//   well inside the registry's 3e-2. l sums the unrounded fp32 weights, as
//   the reference's does. Causal q-tiles launch heaviest first, so the
//   longest blocks do not start last.
// * bf16 / fp16, Sq at most 16 (a decode step's cross-attention):
//   `flash_split`. One block per (batch, head, key split): the 16 query rows
//   (padded) against its split's keys, 64 a stage, 16 per warp; the four
//   warps' partial (m, l, acc) merge in shared memory in warp order, then the
//   split's partial goes to fp32 scratch that the wrapper allocates, and
//   `flash_combine` merges the splits in split order. No atomics: the bits
//   are fixed. The splits (256 keys each) are a function of (Sq, Skv)
//   alone, never of B, H or the card, so a lane's bits do not change with
//   how many lanes run. One split writes the output itself and needs no
//   combine.
// * fp32: `flash_simt`, the first port's CUDA-core body (one warp per query
//   row, fp32 fmaf dot products, K/V converted into padded shared memory),
//   unchanged in its arithmetic; its arrays live in dynamic shared memory so
//   that d 128 (84 KB) and d 256 (166 KB) fit.
//
// Every body takes head dims 16, 32, 64, 128 and 256; an instance above the
// 48 KB static limit asks for its dynamic shared memory once per device.
//
// What bounds it on an H100: at prefill lengths (hundreds of tokens, d 64)
// attention does ~2·d operations per key byte in L2, so the call is bound by
// operations (989 TFLOP/s bf16); a one-query call reads every K/V byte once
// for ~2 operations a byte and is bound by bytes (3.35 TB/s). At the port's
// shapes a call is 0.04-7 GFLOP, with bounds of 1.4-11 µs, and a few hundred
// blocks of 4 warps: the time goes to the latency of each block's sequence
// of KV steps, not to the tensor rate. On an H100, 8 warps or 2 m-tiles a
// warp, 128-key stages, a third ring stage, key splits for long queries and
// fragments loaded a step ahead all measured the same or slower than this
// shape. A wgmma body fed by TMA with warp-specialised producers is later
// work.
#include "mma.cuh"

namespace {

using namespace repro;

struct Strides {  // element strides of a (B, heads, S, d) view; d is unit-stride
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// fp32: the CUDA-core body
// ---------------------------------------------------------------------------

constexpr int FA_BQ = 32, FA_BK = 64, FA_THREADS = 256;
constexpr int FA_WARPS = FA_THREADS / 32;
constexpr int FA_ROWS = FA_BQ / FA_WARPS;  // query rows per warp
constexpr int FA_KPL = FA_BK / 32;         // keys per lane

// The body, on the block's shared arrays: carved from one dynamic
// allocation (flash_simt), each comes in as its own __restrict__ pointer, so
// the compiler still knows that no two of them overlap.
template <typename T, int D>
__device__ __forceinline__ void simt_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int H, int KVH, int Sq, int Skv, const Strides& qs, const Strides& ks,
    const Strides& vs, int causal, int window, float scale, float (*__restrict__ Qs)[D],
    float (*__restrict__ Ks)[D + 1], float (*__restrict__ Vs)[D + 1],
    float (*__restrict__ Ps)[FA_BK]) {
  constexpr int DL = (D + 31) / 32;
  // the dot product's loop is unrolled in full up to d 64; wider heads
  // unroll by 32 (the same sums in the same order, in less code)
  constexpr int DOT_UNROLL = D <= 64 ? D : 32;
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
#pragma unroll (DOT_UNROLL)
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

// shared memory of flash_simt<T, D>: Qs [FA_BQ][D], Ks and Vs [FA_BK][D + 1]
// (padded rows: lanes reading different keys hit different banks), Ps
// [FA_WARPS][FA_BK], all fp32
template <int D>
constexpr int simt_smem_bytes() {
  return (FA_BQ * D + 2 * FA_BK * (D + 1) + FA_WARPS * FA_BK) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
    flash_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ out, int H, int KVH, int Sq, int Skv, Strides qs, Strides ks,
               Strides vs, int causal, int window, float scale) {
  extern __shared__ __align__(16) unsigned char fa_smem[];
  float* f = reinterpret_cast<float*>(fa_smem);
  float* kf = f + FA_BQ * D;
  float* vf = kf + FA_BK * (D + 1);
  simt_body<T, D>(q, k, v, out, H, KVH, Sq, Skv, qs, ks, vs, causal, window, scale,
                  reinterpret_cast<float(*)[D]>(f), reinterpret_cast<float(*)[D + 1]>(kf),
                  reinterpret_cast<float(*)[D + 1]>(vf),
                  reinterpret_cast<float(*)[FA_BK]>(vf + FA_BK * (D + 1)));
}

// ---------------------------------------------------------------------------
// bf16 / fp16: tensor-core tiles
// ---------------------------------------------------------------------------

constexpr int SPLIT_WARPS = 4, SPLIT_THREADS = 32 * SPLIT_WARPS;
constexpr int SPLIT_BK = 16 * SPLIT_WARPS;  // keys of a split block's stage: 16 per warp
constexpr float kLog2e = 1.4426950408889634f;

// The tile body's shape at head dim D: WARPS warps of 16 query rows each (a
// block owns BQ = 16·WARPS rows), BK keys a KV stage, a ring of STAGES.
template <int D>
struct TileShape {
  static constexpr int WARPS = 4, BK = D <= 128 ? 64 : 32, STAGES = 2;
  static constexpr int THREADS = 32 * WARPS, BQ = 16 * WARPS;
};

// a staged row of D elements, padded by 16 bytes so that the 8 rows one
// ldmatrix reads fall on distinct banks
template <int D>
__host__ __device__ constexpr int row_pitch() { return D + 8; }

template <int D>
constexpr int tile_smem_bytes() {  // Q tile, STAGES K and STAGES V stages
  using S = TileShape<D>;
  return (S::BQ + 2 * S::STAGES * S::BK) * row_pitch<D>() * 2;
}

template <int D>
constexpr int split_smem_bytes() {  // Q rows, two K and two V stages (reused to merge)
  return (16 + 4 * SPLIT_BK) * row_pitch<D>() * 2;
}

// 2^x by the special-function unit (ex2.approx.ftz: relative error ~2^-22;
// -inf gives +0); scores are in log2 units, so this is the softmax's exp
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values rounded once to T, packed (lo in the low half)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// `rows` rows of D elements from `src` (row i at src + (row0 + i) * stride)
// into `dst` (pitch row_pitch<D>), by 16-byte cp.async; rows at or past
// `limit` are zero-filled (their scores are masked, and a zero V row adds
// nothing)
template <typename T, int D, int THREADS>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long stride, int row0,
                                           int rows, int limit) {
  constexpr int CPR = D * 2 / 16;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8, gr = row0 + r;
    const bool in = gr < limit;
    cp_async16(smem_addr(dst + r * row_pitch<D>() + c), src + (in ? gr : 0) * stride + c, in);
  }
}

// One warp's 16 query rows (Qw, staged) against NT·8 staged keys (Kt, Vt),
// the first at absolute index k0; the rows' absolute indices start at qr0.
// Updates the warp's online softmax: o (16 x D, mma accumulator layout), m
// and l of the thread's two rows (lane/4 and lane/4 + 8), l per thread (its
// quad sums it at the end). Scores are in log2 units.
template <typename T, int D, int NT>
__device__ __forceinline__ void warp_attend(const T* Qw, const T* Kt, const T* Vt, int k0,
                                            int qr0, int Skv, int causal, int window,
                                            float scale_log2, float (&o)[D / 8][4],
                                            float (&m)[2], float (&l)[2]) {
  constexpr int P = row_pitch<D>();
  constexpr int KD = D / 16, ND = D / 8;
  const int lane = threadIdx.x % 32;

  // S = Q·Kᵀ: A from Q rows (x4: rows 0-15 x k 0-15), B from K rows, which
  // are the columns of Kᵀ (x4: two 8-key n-tiles x two k halves)
  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
  const uint32_t qa = smem_addr(Qw + (lane % 16) * P + (lane / 16) * 8);
  const uint32_t ka = smem_addr(Kt + (lane % 8 + (lane / 16) * 8) * P + ((lane / 8) % 2) * 8);
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, qa + kk * 16 * 2);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, ka + (np * 16 * P + kk * 16) * 2);
      mma16816<T>(s[2 * np], a, b[0], b[1]);
      mma16816<T>(s[2 * np + 1], a, b[2], b[3]);
    }
  }

  // scale and mask (only where some pair of this warp's rows and keys is
  // disallowed), then each row's new running max across its quad
  const int r0 = qr0 + lane / 4, kc = k0 + (lane % 4) * 2;
  const bool edge = k0 + NT * 8 > Skv || (causal && k0 + NT * 8 - 1 > qr0) ||
                    (window > 0 && qr0 + 15 - k0 >= window);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[nt][e] * scale_log2;
      if (edge) {
        const int kj = kc + nt * 8 + (e & 1), qi = r0 + (e >> 1) * 8;
        bool allow = true;
        if (causal) allow = kj <= qi;
        if (window > 0) allow = allow && (qi - kj) < window;
        x = kj >= Skv ? -INFINITY : (allow ? x : kNegInf);
      }
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = exp2_fast(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    o[nd][0] *= corr[0];
    o[nd][1] *= corr[0];
    o[nd][2] *= corr[1];
    o[nd][3] *= corr[1];
  }

  // O += P·V: the score accumulators of two n-tiles are one A fragment of P
  // (16 keys), rounded once to T; B from V rows (keys) by ldmatrix.trans
  const uint32_t va = smem_addr(Vt + (lane % 8 + ((lane / 8) % 2) * 8) * P + (lane / 16) * 8);
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    uint32_t a[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nt = 2 * j + half;
      const float p0 = exp2_fast(s[nt][0] - m[0]), p1 = exp2_fast(s[nt][1] - m[0]);
      const float p2 = exp2_fast(s[nt][2] - m[1]), p3 = exp2_fast(s[nt][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      a[2 * half] = pack2<T>(p0, p1);
      a[2 * half + 1] = pack2<T>(p2, p3);
    }
#pragma unroll
    for (int dp = 0; dp < ND / 2; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, va + (j * 16 * P + dp * 16) * 2);
      mma16816<T>(o[2 * dp], a, b[0], b[1]);
      mma16816<T>(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// the quad's four partial denominators of each of the thread's two rows
__device__ __forceinline__ void quad_sum(float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

template <int ND>
__device__ __forceinline__ void zero_state(float (&o)[ND][4], float (&m)[2], float (&l)[2]) {
  m[0] = m[1] = kNegInf;
  l[0] = l[1] = 0.0f;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.0f;
}

// Tile path: grid (B·H, q-tiles); a block owns BQ query rows of one
// (batch, head) and walks every key tile some row of it may attend to.
template <typename T, int D>
__global__ void __launch_bounds__(TileShape<D>::THREADS)
    flash_tile(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ out, int H, int KVH, int Sq, int Skv, Strides qs, Strides ks,
               Strides vs, int causal, int window, float scale_log2) {
  using S = TileShape<D>;
  constexpr int BK = S::BK, BQ = S::BQ, NS = S::STAGES;
  constexpr int P = row_pitch<D>(), ND = D / 8;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  T* Qs = reinterpret_cast<T*>(fa_smem);  // [BQ][P]
  T* Ks = Qs + BQ * P;                     // [NS][BK][P]
  T* Vs = Ks + NS * BK * P;                // [NS][BK][P]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kh = h / (H / KVH);
  // causal: the last q-tiles see the most keys and launch first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qw = q0 + warp * 16;  // this warp's first row
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  // the keys some row of this block may attend to: tiles outside are fully
  // masked for every row and are skipped
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // the ring: stages 0..NS-2 in flight before the loop; step t refills the
  // stage that step t-1 consumed with tile t+NS-1
  stage_rows<T, D, S::THREADS>(Qs, qb, qs.s, q0, BQ, Sq);
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < n_tiles) {
      stage_rows<T, D, S::THREADS>(Ks + t * BK * P, kb, ks.s, k_begin + t * BK, BK, Skv);
      stage_rows<T, D, S::THREADS>(Vs + t * BK * P, vb, vs.s, k_begin + t * BK, BK, Skv);
    }
    cp_async_commit();
  }

  float o[ND][4], m[2], l[2];
  zero_state(o, m, l);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BK, ahead = t + NS - 1;
    if (ahead < n_tiles) {
      const int st = ahead % NS;
      stage_rows<T, D, S::THREADS>(Ks + st * BK * P, kb, ks.s, k_begin + ahead * BK, BK, Skv);
      stage_rows<T, D, S::THREADS>(Vs + st * BK * P, vb, vs.s, k_begin + ahead * BK, BK, Skv);
    }
    cp_async_commit();
    cp_async_wait<NS - 1>();  // this tile (and Q) landed
    __syncthreads();
    const int cur = t % NS;
    warp_attend<T, D, BK / 8>(Qs + warp * 16 * P, Ks + cur * BK * P, Vs + cur * BK * P, k0, qw,
                              Skv, causal, window, scale_log2, o, m, l);
    __syncthreads();  // the stage is consumed before a later copy refills it
  }
  quad_sum(l);

  T* ob = out + ((long long)b * H + h) * Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qw + lane / 4 + 8 * r;
    if (qi >= Sq) continue;
    const float inv = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int c = nd * 8 + (lane % 4) * 2;
      *reinterpret_cast<uint32_t*>(ob + (long long)qi * D + c) =
          pack2<T>(o[nd][2 * r] / inv, o[nd][2 * r + 1] / inv);
    }
  }
}

// Split-KV: grid (B·H, n_split), split s owns keys [s·split_len,
// (s+1)·split_len). Partials in `part`: acc (B·H, n_split, Sq, D), then m and
// l (B·H, n_split, Sq) each, fp32, m in log2 units.
template <typename T, int D>
__global__ void __launch_bounds__(SPLIT_THREADS)
    flash_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, float* __restrict__ part, int H, int KVH, int Sq, int Skv,
                Strides qs, Strides ks, Strides vs, int causal, int window, float scale_log2,
                int split_len) {
  constexpr int BK = SPLIT_BK, P = row_pitch<D>(), ND = D / 8;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  T* Qs = reinterpret_cast<T*>(fa_smem);  // [16][P]
  T* Ks = Qs + 16 * P;                     // [2][BK][P]
  T* Vs = Ks + 2 * BK * P;                 // [2][BK][P]

  const int bh = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int b = bh / H, h = bh % H, kh = h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  // the split's keys, less those the causal mask hides from every row (the
  // last row is Sq - 1); a window hides none from row 0
  const int s0 = split * split_len;
  const int k_end = min(min(Skv, s0 + split_len), causal ? Sq : Skv);
  const int n_tiles = k_end > s0 ? (k_end - s0 + BK - 1) / BK : 0;

  stage_rows<T, D, SPLIT_THREADS>(Qs, qb, qs.s, 0, 16, Sq);
  if (n_tiles > 0) {
    stage_rows<T, D, SPLIT_THREADS>(Ks, kb, ks.s, s0, BK, Skv);
    stage_rows<T, D, SPLIT_THREADS>(Vs, vb, vs.s, s0, BK, Skv);
  }
  cp_async_commit();

  float o[ND][4], m[2], l[2];
  zero_state(o, m, l);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = s0 + t * BK;
    if (t + 1 < n_tiles) {
      const int nxt = (t + 1) % 2;
      stage_rows<T, D, SPLIT_THREADS>(Ks + nxt * BK * P, kb, ks.s, k0 + BK, BK, Skv);
      stage_rows<T, D, SPLIT_THREADS>(Vs + nxt * BK * P, vb, vs.s, k0 + BK, BK, Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int cur = t % 2, kw = k0 + warp * 16;  // this warp's 16 keys
    if (kw < k_end)
      warp_attend<T, D, 2>(Qs, Ks + (cur * BK + warp * 16) * P, Vs + (cur * BK + warp * 16) * P,
                           kw, 0, Skv, causal, window, scale_log2, o, m, l);
    __syncthreads();
  }
  quad_sum(l);

  // merge the four warps' partials in warp order, in the stages' memory
  cp_async_wait<0>();
  __syncthreads();
  float* Ms = reinterpret_cast<float*>(Ks);  // [SPLIT_WARPS][16]
  float* Ls = Ms + SPLIT_WARPS * 16;         // [SPLIT_WARPS][16]
  float* Os = Ls + SPLIT_WARPS * 16;         // [SPLIT_WARPS][16][D]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = lane / 4 + 8 * r;
    if (lane % 4 == 0) {
      Ms[warp * 16 + row] = m[r];
      Ls[warp * 16 + row] = l[r];
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int c = nd * 8 + (lane % 4) * 2;
      Os[(warp * 16 + row) * D + c] = o[nd][2 * r];
      Os[(warp * 16 + row) * D + c + 1] = o[nd][2 * r + 1];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Sq * D; i += SPLIT_THREADS) {
    const int r = i / D, c = i % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < SPLIT_WARPS; ++w) mm = fmaxf(mm, Ms[w * 16 + r]);
    float ll = 0.0f, acc = 0.0f;
#pragma unroll
    for (int w = 0; w < SPLIT_WARPS; ++w) {
      const float f = exp2_fast(Ms[w * 16 + r] - mm);
      ll += Ls[w * 16 + r] * f;
      acc += Os[(w * 16 + r) * D + c] * f;
    }
    if (n_split == 1) {
      out[((long long)bh * Sq + r) * D + c] = from_f32<T>(acc / fmaxf(ll, 1e-30f));
    } else {
      const long long row = ((long long)bh * n_split + split) * Sq + r;
      part[row * D + c] = acc;
      if (c == 0) {
        const long long n_rows = (long long)gridDim.x * n_split * Sq;
        part[n_rows * D + row] = mm;
        part[n_rows * (D + 1) + row] = ll;
      }
    }
  }
}

// The splits of every (batch, head, query row) merged in split order: one
// block per (batch, head), its Sq <= 16 rows. Partials in `part`: acc
// (B·H, n_split, Sq, D), then m and l (B·H, n_split, Sq) each, fp32, m in
// log2 units.
template <typename T>
__global__ void __launch_bounds__(SPLIT_THREADS)
    flash_combine(const float* __restrict__ part, T* __restrict__ out, int Sq, int D,
                  int n_split) {
  const int bh = blockIdx.x;
  const long long n_rows = (long long)gridDim.x * n_split * Sq;
  const float* pm = part + n_rows * D;
  const float* pl = part + n_rows * (D + 1);
  for (int i = threadIdx.x; i < Sq * D; i += SPLIT_THREADS) {
    const int r = i / D, c = i % D;
    const long long row0 = (long long)bh * n_split * Sq + r;  // split s: row0 + s·Sq
    float mm = kNegInf;
    for (int s = 0; s < n_split; ++s) mm = fmaxf(mm, pm[row0 + (long long)s * Sq]);
    float ll = 0.0f, acc = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      const long long row = row0 + (long long)s * Sq;
      const float f = exp2_fast(pm[row] - mm);
      ll += pl[row] * f;
      acc += part[row * D + c] * f;
    }
    out[((long long)bh * Sq + r) * D + c] = from_f32<T>(acc / fmaxf(ll, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum Path : int { kTile = 0, kShortQuery = 1 };  // the wrapper's plan (flash_plan)

struct Call {
  const void *q, *k, *v;
  void* out;
  float* part;
  int B, H, KVH, Sq, Skv;
  Strides qs, ks, vs;
  int causal, window;
  float scale;
  int path, n_split, split_len;
  cudaStream_t s;
};

template <typename T, int D>
cudaError_t launch_simt(const Call& c) {
  constexpr int smem = simt_smem_bytes<D>();
  static bool ready[kMaxDevices] = {};
  cudaError_t err = allow_dynamic_smem(flash_simt<T, D>, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(c.B * c.H, (c.Sq + FA_BQ - 1) / FA_BQ);
  flash_simt<T, D><<<grid, FA_THREADS, smem, c.s>>>(
      static_cast<const T*>(c.q), static_cast<const T*>(c.k), static_cast<const T*>(c.v),
      static_cast<T*>(c.out), c.H, c.KVH, c.Sq, c.Skv, c.qs, c.ks, c.vs, c.causal, c.window,
      c.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_tile(const Call& c) {
  using S = TileShape<D>;
  constexpr int smem = tile_smem_bytes<D>();
  static bool ready[kMaxDevices] = {};
  cudaError_t err = allow_dynamic_smem(flash_tile<T, D>, smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(c.B * c.H, (c.Sq + S::BQ - 1) / S::BQ);
  flash_tile<T, D><<<grid, S::THREADS, smem, c.s>>>(
      static_cast<const T*>(c.q), static_cast<const T*>(c.k), static_cast<const T*>(c.v),
      static_cast<T*>(c.out), c.H, c.KVH, c.Sq, c.Skv, c.qs, c.ks, c.vs, c.causal, c.window,
      c.scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_short_query(const Call& c) {
  if (c.Sq > 16) return cudaErrorInvalidValue;
  constexpr int smem = split_smem_bytes<D>();
  static bool ready[kMaxDevices] = {};
  cudaError_t err = allow_dynamic_smem(flash_split<T, D>, smem, ready);
  if (err != cudaSuccess) return err;
  flash_split<T, D><<<dim3(c.B * c.H, c.n_split), SPLIT_THREADS, smem, c.s>>>(
      static_cast<const T*>(c.q), static_cast<const T*>(c.k), static_cast<const T*>(c.v),
      static_cast<T*>(c.out), c.part, c.H, c.KVH, c.Sq, c.Skv, c.qs, c.ks, c.vs, c.causal,
      c.window, c.scale * kLog2e, c.split_len);
  err = cudaGetLastError();
  if (err != cudaSuccess || c.n_split == 1) return err;
  flash_combine<T><<<c.B * c.H, SPLIT_THREADS, 0, c.s>>>(c.part, static_cast<T*>(c.out), c.Sq,
                                                      D, c.n_split);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_path(const Call& c) {
  if constexpr (sizeof(T) == 4) {
    return c.path == kTile ? launch_simt<T, D>(c) : cudaErrorInvalidValue;
  } else {
    return c.path == kTile ? launch_tile<T, D>(c) : launch_short_query<T, D>(c);
  }
}

template <typename T>
cudaError_t launch_d(int D, const Call& c) {
  switch (D) {
    case 16: return launch_path<T, 16>(c);
    case 32: return launch_path<T, 32>(c);
    case 64: return launch_path<T, 64>(c);
    case 128: return launch_path<T, 128>(c);
    case 256: return launch_path<T, 256>(c);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, D), k/v (B, KVH, Skv, D) with the given element strides and a
// unit-stride last dim, every row start and row stride 16-byte aligned; out
// (B, H, Sq, D) contiguous. window <= 0: none. D is one of 16, 32, 64, 128,
// 256. path 0: the tile body (fp32: the CUDA-core body), n_split 1, split_len
// unused; path 1 (bf16 / fp16, Sq <= 16): the short-query body over n_split
// key splits of `split_len` keys each (a multiple of 64) that cover Skv; with
// more than one split their partials go to `part` (B·H·n_split·Sq·(D + 2)
// fp32) and a combine pass writes the output.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int H, int KVH, int Sq, int Skv, int D,
                                      long long qsb, long long qsh, long long qss,
                                      long long ksb, long long ksh, long long kss,
                                      long long vsb, long long vsh, long long vss, int causal,
                                      int window, float scale, int dtype, int path, void* part,
                                      int n_split, int split_len, void* stream) {
  if (KVH < 1 || H % KVH != 0 || (path != kTile && path != kShortQuery))
    return cudaErrorInvalidValue;
  if (path == kTile ? n_split != 1
                    : n_split < 1 || split_len < SPLIT_BK || split_len % SPLIT_BK != 0 ||
                          (long long)n_split * split_len < Skv ||
                          (n_split > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const Call c{q, k, v, out, static_cast<float*>(part), B, H, KVH, Sq, Skv,
               Strides{qsb, qsh, qss}, Strides{ksb, ksh, kss}, Strides{vsb, vsh, vss},
               causal, window, scale, path, n_split, split_len,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kF32: return launch_d<float>(D, c);
    case kBF16: return launch_d<__nv_bfloat16>(D, c);
    case kF16: return launch_d<__half>(D, c);
    default: return cudaErrorInvalidValue;
  }
}
