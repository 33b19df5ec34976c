// The kernel body of decode_attention and paged_decode_attention: one query
// row per sequence against a KV cache, split over the cache length.
//
// Replaces the Pallas TPU kernels `decode_attention`
// (src/repro/kernels/flash/decode_attention.py:67, body `_kernel` at :29) and
// `paged_decode_attention` (:200, body `_paged_kernel` at :149). A slot is
// valid when pos >= 0, pos <= current and, with a window, current - pos <
// window; invalid slots score -1e30 as in the reference, so a lane whose
// every slot is invalid still gives a finite result (uniform weights over its
// slots, the reference's softmax over -1e30). Padding past the cache gets no
// weight (-inf).
//
// What bounds it on an H100: one query row per sequence does ~2 operations
// per cache element, so a call is bound by the bytes of the cache (3.35
// TB/s); at the serve path's shapes those are a few MB, read in about a
// microsecond, so what the design fights is latency: too few blocks, loads
// issued one after another, long chains of dependent arithmetic in a block.
//
// The design:
//   * Grid (B·KV·row tiles, n_split). The wrapper's plan (`decode_plan(s,
//     bk)` in kernels/flash/decode_attention.py) cuts the cache length into
//     n_split splits of `split_len` slots, a whole number of bk-slot chunks
//     each, none empty, from (S, bk) alone: never from B, the heads or the
//     card, so a lane's bits do not change with how many lanes run beside
//     it. One block owns one (lane, kv head, split) and the query heads of
//     the group (16-bit: 16 of them a row tile) share every K/V row it stages.
//   * Loads. The split's slots stream through a ring of stages, K and V rows
//     of the kv head by 16-byte cp.async in the input dtype (rows padded by
//     16 bytes, so the 8 rows of one shared-memory phase sit on distinct
//     banks), the positions beside them by 4-byte cp.async; a stage's rows
//     may come from several chunks (pages). Values become fp32 in registers,
//     not in shared memory: at most 144 KB at d 256 (bf16, two stages), 85
//     KB in fp32, against 165 KB of fp32 staging before.
//   * bf16 and fp16: tensor cores (`decode_split_tc`, templated on the
//     16-bit type: mma.sync .bf16 or .f16). The group's query heads are
//     the 16 rows of an mma.sync.m16n8k16 tile (padded with zero rows; a
//     group of 32 takes two row tiles, each its own block), each warp takes
//     16 slots of a 64-slot stage: S = Q·Kᵀ from ldmatrix fragments, the
//     masks from the staged positions, an online softmax in the
//     accumulator's layout (exp2 of log2-scaled scores), O += P·V with P
//     rounded once to the input type (as flash_attention's tiles do: one
//     relative rounding of at most 2^-8 a weight in bf16, 2^-11 in fp16,
//     inside the registry's 3e-2; an fp16 weight below 2^-24, a score more
//     than 24 log2 units under the running max, rounds to zero). At the
//     end of the split the four warps merge in warp order.
//   * fp32: CUDA cores (`decode_split_simt`). P = 128 / SR threads a slot
//     (SR slots a stage, <= bk) split into row groups and, where the group
//     has fewer rows than P, into head-dim parts summed by xor shuffles, so
//     neither one query head a group (whisper's MHA) nor 8- or 16-slot pages
//     leave lanes idle; P·V column vectors over slices of the stage's slots;
//     the softmax a warp a row.
//   * Combine. With one split the block writes the output itself. With more
//     (at most 8) the n_split blocks of a (lane, kv head, row tile) are one
//     thread-block cluster: each keeps its fp32 partial (m, l, acc[D]) per
//     query head in shared memory, and after a cluster barrier the blocks
//     read each other's partials (distributed shared memory) and merge them
//     in split order: m = max, each part scaled by 2^(m_i - m), one
//     division, one rounding to T. One launch, no workspace, no atomics.
//
// The bodies take the chunk size BK (the fp32 body's stage depends on it, so
// there it is a template parameter) and a chunk -> rows map, and two sources
// instantiate them, each built by its own nvcc so that the two compile side
// by side (decode_attention.cu, paged_decode_attention.cu):
//   * MonoRows: a (B, S, KV, d) cache, slot s of lane b at ((b·S + s)·KV)·d;
//   * PagedRows: a shared (N, bs, KV, d) arena read through a (B, nb) block
//     table with BK = bs, so a chunk is one page: slot s of lane b in arena
//     block t = table[b, s / bs] at t·block_stride + (s % bs)·KV·d; t = -1
//     is an unmapped page: its slots are masked (-1e30, as the reference's
//     `mapped`; its positions are staged as -1), and the row index is
//     clamped to 0 before any load (the reference's `jnp.maximum(t, 0)`).
// With BK = bs and the plan of (nb·bs, bs) both walk the same slots in the
// same stages through the same arithmetic, so paged_decode_attention equals
// decode_attention(bk=bs) on the gathered pages bit for bit (the reference's
// contract). Every slot of the cache is read: skipping chunks that hold no
// valid slot would put a read of the positions before the first K/V load.
//
// Head dims 16, 32, 64, 128 and 256; fp32, bf16 and fp16.
#pragma once

#include <cooperative_groups.h>

#include "mma.cuh"

namespace repro {
namespace decode {

constexpr int DA_THREADS = 128, DA_WARPS = DA_THREADS / 32, DA_BKMAX = 64;
constexpr int DA_GMAX = 32;    // query heads per kv head
constexpr int DA_STAGES = 3;   // the fp32 ring's stages
constexpr int DA_MAX_SPLITS = 8;   // splits of a call: a block each, one portable cluster

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
  __host__ __device__ __forceinline__ int length() const { return S; }
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
  __host__ __device__ __forceinline__ int length() const { return nb * bs; }
  __device__ __forceinline__ Chunk chunk(int b, int s0, int) const {
    const int t = table[(long long)b * nb + s0 / bs];
    const long long row = max(t, 0);   // an unmapped page reads row 0
    return {row * block_stride, pos + row * pos_stride, t >= 0};
  }
};

// a valid slot: written, not after the current position, inside the window
__device__ __forceinline__ bool slot_valid(int p, int cur, int window) {
  return p >= 0 && p <= cur && (window <= 0 || cur - p < window);
}

// 2^x by the special-function unit (ex2.approx.ftz: relative error ~2^-22;
// -inf gives +0); scores are in log2 units, so this is the softmax's exp
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The splits' partials merged in split order across the cluster (one block a
// split, cluster rank = split): m = max, each part scaled by 2^(m_s - m) (log2
// units; every m >= -1e30, so never 2^(-inf - -inf)), one division, one
// rounding to T. Each block holds its partial in shared memory: acc (rows x
// D, `pitch` apart), m and l (rows); `out` is the rows' (rows, D) output.
// `F` is this block's scratch of (DA_MAX_SPLITS + 1)·rows floats: each row's
// split weights and denominator, taken once a row; every split's read of an
// element is in flight before the first add.
template <typename T, int THREADS>
__device__ __forceinline__ void cluster_combine(const float* acc, const float* m,
                                                const float* l, int pitch, int rows,
                                                T* __restrict__ out, int D, int n_split,
                                                float* F) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every split's partial is in its shared memory
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    float ms[DA_MAX_SPLITS], ls[DA_MAX_SPLITS], mm = kNegInf;
#pragma unroll
    for (int s = 0; s < DA_MAX_SPLITS; ++s) {
      ms[s] = s < n_split ? cluster.map_shared_rank(m, s)[r] : kNegInf;
      ls[s] = s < n_split ? cluster.map_shared_rank(l, s)[r] : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < DA_MAX_SPLITS; ++s) mm = fmaxf(mm, ms[s]);
    float ll = 0.0f;
#pragma unroll
    for (int s = 0; s < DA_MAX_SPLITS; ++s) {
      if (s >= n_split) break;
      const float f = exp2_approx(ms[s] - mm);
      F[s * rows + r] = f;
      ll += ls[s] * f;
    }
    F[DA_MAX_SPLITS * rows + r] = fmaxf(ll, 1e-30f);
  }
  __syncthreads();
  for (int i = (int)cluster.block_rank() * THREADS + threadIdx.x; i < rows * D;
       i += n_split * THREADS) {
    const int r = i / D, c = i % D;
    float p[DA_MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < DA_MAX_SPLITS; ++s)
      p[s] = s < n_split ? cluster.map_shared_rank(acc, s)[r * pitch + c] : 0.0f;
    float a = 0.0f;
#pragma unroll
    for (int s = 0; s < DA_MAX_SPLITS; ++s)
      if (s < n_split) a += p[s] * F[s * rows + r];
    out[(long long)r * D + c] = from_f32<T>(a / F[DA_MAX_SPLITS * rows + r]);
  }
  cluster.sync();   // no block leaves while another still reads its partial
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

// The fixed geometry of an fp32 instance: 4 floats in 16 bytes, NVEC vectors
// a row; SR slots a stage (<= BK, ~8 KB of K); P score threads a slot; at
// most RPT score rows and UPT P·V column vectors a thread.
template <int D, int BK>
struct Simt {
  static constexpr int VW = 4, NVEC = D / VW;
  static constexpr int SR_CAP = 8192 / (D * 4);
  static constexpr int SR_FIT = SR_CAP < 8 ? 8 : (SR_CAP > 64 ? 64 : SR_CAP);
  static constexpr int SR = BK < SR_FIT ? BK : SR_FIT;
  static constexpr int PITCH = D + VW;   // a staged row, padded by 16 bytes
  static constexpr int QP = D + 4;       // a query row, padded by 16 bytes
  static constexpr int P = DA_THREADS / SR;
  static constexpr int RPT = (DA_GMAX + P - 1) / P;
  static constexpr int UPT = (DA_GMAX * NVEC + DA_THREADS - 1) / DA_THREADS;
  static_assert(BK % SR == 0 && SR * P == DA_THREADS, "a stage is whole slots of a chunk");
  // ring stages a split of split_len slots uses: DA_STAGES, or fewer
  static __host__ __device__ constexpr int stages(int split_len) {
    return (split_len + SR - 1) / SR < DA_STAGES ? (split_len + SR - 1) / SR : DA_STAGES;
  }
  // dynamic shared memory for g query heads a kv head and ns stages: K and V
  // rings [ns][SR][PITCH] (first: 16-byte aligned), Qs [g][QP] and the
  // stage's scores [g][SR], positions [ns][SR], then m, l and the stage's
  // correction [g] each
  static constexpr int smem_bytes(int g, int ns) {
    return (2 * ns * SR * PITCH + g * QP + g * SR + ns * SR + 3 * g) * 4;
  }
};

// One block: lane b = blockIdx.x / KV, kv head blockIdx.x % KV, split
// blockIdx.y over slots [split·split_len, min(S, (split+1)·split_len)); the
// n_split blocks of a (lane, kv head) are one cluster, which merges their
// partials (cluster_combine).
template <int D, int BK, typename Rows>
__global__ void __launch_bounds__(DA_THREADS)
    decode_split_simt(const float* __restrict__ q, const float* __restrict__ kc,
                      const float* __restrict__ vc, const Rows rows, const int* __restrict__ cur,
                      float* __restrict__ out, int H, int KV, int window, float scale_log2,
                      int split_len) {
  using Sh = Simt<D, BK>;
  constexpr int VW = Sh::VW, NVEC = Sh::NVEC, SR = Sh::SR, PITCH = Sh::PITCH, QP = Sh::QP;
  constexpr int P = Sh::P, NS = DA_STAGES;
  extern __shared__ __align__(16) unsigned char da_smem[];
  const int g = H / KV, ns = Sh::stages(split_len);   // ring slot: stage % NS < ns
  float* Ks = reinterpret_cast<float*>(da_smem);   // [ns][SR][PITCH]
  float* Vs = Ks + ns * SR * PITCH;                // [ns][SR][PITCH]
  float* Qs = Vs + ns * SR * PITCH;                // [g][QP]
  float* Ss = Qs + g * QP;                         // [g][SR]: scores, then weights
  int* Pos = reinterpret_cast<int*>(Ss + g * SR);  // [ns][SR]
  float* Ms = reinterpret_cast<float*>(Pos + ns * SR);
  float* Ls = Ms + g;
  float* Cs = Ls + g;

  const int b = blockIdx.x / KV, kh = blockIdx.x % KV;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int S = rows.length();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cur_b = cur[b];
  const int s_begin = split * split_len, s_end = min(S, s_begin + split_len);
  const int n_st = (s_end - s_begin + SR - 1) / SR;

  // one stage of SR slots into ring slot st % NS; a stage lies in one chunk
  auto issue = [&](int st) {
    const int s0 = s_begin + st * SR, slot = st % NS;
    const int c0 = s0 - s0 % BK, o = s0 - c0;
    const Chunk ch = rows.chunk(b, c0, D);
    float* ks = Ks + slot * SR * PITCH;
    float* vs = Vs + slot * SR * PITCH;
    for (int i = tid; i < SR * NVEC; i += DA_THREADS) {
      const int r = i / NVEC, c = (i % NVEC) * VW;
      const bool in = s0 + r < S;
      const long long off = in ? ch.base + ((long long)(o + r) * KV + kh) * D + c : 0;
      cp_async16(smem_addr(ks + r * PITCH + c), kc + off, in);
      cp_async16(smem_addr(vs + r * PITCH + c), vc + off, in);
    }
    int* ps = Pos + slot * SR;
    for (int i = tid; i < SR; i += DA_THREADS) {
      if (ch.mapped && s0 + i < S)
        cp_async4(smem_addr(ps + i), ch.pos + o + i);
      else
        ps[i] = -1;   // masked; past the cache is told by the slot index
    }
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_st) issue(i);
    cp_async_commit();
  }
  const float* qb = q + ((long long)b * H + (long long)kh * g) * D;
  for (int i = tid; i < g * D; i += DA_THREADS) Qs[(i / D) * QP + i % D] = qb[i];
  for (int r = tid; r < g; r += DA_THREADS) {
    Ms[r] = -INFINITY;
    Ls[r] = 0.0f;
  }

  // scores: slot j of P threads, RG row groups of DP head-dim parts
  int DP = 1;
  while (DP * 2 * g <= P && DP * 2 <= NVEC) DP *= 2;
  const int RG = P / DP, rpt = (g + RG - 1) / RG;
  const int sj = tid / P, srg = (tid % P) / DP, sdp = tid % DP;
  // P·V: SP slot parts of G threads; a thread's column vector pcv of rows
  // prg + RGv·k
  int SP = 1;
  while (SP * 2 * g * NVEC <= DA_THREADS && SP * 2 <= (SR < 32 ? SR : 32)) SP *= 2;
  const int RGv = DA_THREADS / SP / NVEC;
  const int psp = tid % SP, pcv = (tid / SP) % NVEC, prg = tid / SP / NVEC;

  float acc[Sh::UPT][VW];
#pragma unroll
  for (int k = 0; k < Sh::UPT; ++k)
#pragma unroll
    for (int e = 0; e < VW; ++e) acc[k][e] = 0.0f;

  for (int t = 0; t < n_st; ++t) {
    if (t + NS - 1 < n_st) issue(t + NS - 1);   // its ring slot was freed last step
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncthreads();   // stage t (and Qs, Ms, Ls) visible to all
    const int slot = t % NS, s0 = s_begin + t * SR;
    {
      float dot[Sh::RPT];
#pragma unroll
      for (int rr = 0; rr < Sh::RPT; ++rr) dot[rr] = 0.0f;
      const float* krow = Ks + (slot * SR + sj) * PITCH;
      for (int v = sdp; v < NVEC; v += DP) {
        const float4 k4 = *reinterpret_cast<const float4*>(krow + v * VW);
        const float kf[VW] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int rr = 0; rr < Sh::RPT; ++rr) {
          const int r = srg + RG * rr;
          if (rr < rpt && r < g) {
            const float* qr = Qs + r * QP + v * VW;
#pragma unroll
            for (int e = 0; e < VW; ++e) dot[rr] = fmaf(qr[e], kf[e], dot[rr]);
          }
        }
      }
      const int s = s0 + sj;
      const bool ok = s < S && slot_valid(Pos[slot * SR + sj], cur_b, window);
#pragma unroll
      for (int rr = 0; rr < Sh::RPT; ++rr) {
        if (rr >= rpt) break;   // block-uniform
        for (int o = 1; o < DP; o <<= 1) dot[rr] += __shfl_xor_sync(0xffffffffu, dot[rr], o);
        const int r = srg + RG * rr;
        if (sdp == 0 && r < g)
          Ss[r * SR + sj] = s >= S ? -INFINITY : (ok ? dot[rr] * scale_log2 : kNegInf);
      }
    }
    __syncthreads();
    for (int r = warp; r < g; r += DA_WARPS) {   // the online softmax, a warp a row
      constexpr int JPL = (SR + 31) / 32;
      const float m_old = Ms[r];
      float sv[JPL], mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < JPL; ++jj) {
        const int j = lane + 32 * jj;
        sv[jj] = j < SR ? Ss[r * SR + j] : -INFINITY;
        mx = fmaxf(mx, sv[jj]);
      }
      // every stage holds a slot inside the cache, so m_new is finite
      const float m_new = fmaxf(m_old, warp_max(mx));
      const float corr = exp2_approx(m_old - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < JPL; ++jj) {
        const int j = lane + 32 * jj;
        const float p = exp2_approx(sv[jj] - m_new);
        if (j < SR) Ss[r * SR + j] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        Ms[r] = m_new;
        Ls[r] = Ls[r] * corr + psum;
        Cs[r] = corr;
      }
    }
    __syncthreads();
    {
      const float* vst = Vs + slot * SR * PITCH + pcv * VW;
#pragma unroll
      for (int k = 0; k < Sh::UPT; ++k) {
        const int r = prg + RGv * k;
        if (r < g) {
          const float c = Cs[r];
#pragma unroll
          for (int e = 0; e < VW; ++e) acc[k][e] *= c;
        }
      }
      for (int j = psp; j < SR; j += SP) {
        const float4 v4 = *reinterpret_cast<const float4*>(vst + j * PITCH);
        const float vf[VW] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int k = 0; k < Sh::UPT; ++k) {
          const int r = prg + RGv * k;
          if (r < g) {
            const float p = Ss[r * SR + j];
#pragma unroll
            for (int e = 0; e < VW; ++e) acc[k][e] = fmaf(p, vf[e], acc[k][e]);
          }
        }
      }
    }
    __syncthreads();   // Ss and this ring slot are free
  }
  cp_async_wait<0>();

  // the slot parts' sums, then the output, or the split's partial in
  // place of Qs for the cluster's merge
  float* ob = out + ((long long)b * H + (long long)kh * g) * D;
#pragma unroll
  for (int k = 0; k < Sh::UPT; ++k) {
#pragma unroll
    for (int e = 0; e < VW; ++e)
      for (int o = 1; o < SP; o <<= 1) acc[k][e] += __shfl_xor_sync(0xffffffffu, acc[k][e], o);
    const int r = prg + RGv * k;
    if (psp != 0 || r >= g) continue;
    const int c = pcv * VW;
    const float inv = fmaxf(Ls[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      if (n_split == 1)
        ob[r * D + c + e] = acc[k][e] / inv;
      else
        Qs[r * QP + c + e] = acc[k][e];
    }
  }
  if (n_split > 1) cluster_combine<float, DA_THREADS>(Qs, Ms, Ls, QP, g, ob, D, n_split, Ks);
}

// ---------------------------------------------------------------------------
// bf16 and fp16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4, TC_THREADS = 32 * TC_WARPS;
constexpr int TC_ROWS = 16;              // query heads of a row tile: the mma's M
constexpr int TC_SR = 16 * TC_WARPS;     // slots a stage: 16 a warp
constexpr int TC_STAGES = 2;

template <int D>
struct Tc {
  static constexpr int PITCH = D + 8;    // a staged row, padded by 16 bytes
  static __host__ __device__ constexpr int stages(int split_len) {
    return (split_len + TC_SR - 1) / TC_SR < TC_STAGES ? (split_len + TC_SR - 1) / TC_SR
                                                        : TC_STAGES;
  }
  // Qs [16][PITCH], K and V rings [ns][TC_SR][PITCH] (16-bit), positions
  // [ns][TC_SR]; after the last stage the rings hold the warps' merge
  static constexpr int smem_bytes(int ns) {
    return (TC_ROWS + 2 * ns * TC_SR) * PITCH * 2 + ns * TC_SR * 4;
  }
  static_assert(2 * TC_SR * PITCH * 2 >= (2 * TC_WARPS * TC_ROWS + TC_WARPS * TC_ROWS * D +
                                          (DA_MAX_SPLITS + 3) * TC_ROWS) * 4,
                "the merges fit in one stage of the rings");
};

// two fp32 values rounded once to T (bf16 or fp16, to nearest even),
// packed (lo in the low half)
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

// One block: lane b, kv head kh and row tile mt of blockIdx.x = (b·KV + kh)·MT
// + mt (query heads kh·g + 16·mt + [0, 16) of the group's g), split
// blockIdx.y; a tile's n_split blocks are one cluster, as in
// decode_split_simt. The chunk size bk only maps slots to rows: a stage may
// span chunks. T is bf16 or fp16: the mma's operand type and the one
// rounding of P before P·V; scores, softmax state and merges are fp32.
template <int D, typename T, typename Rows>
__global__ void __launch_bounds__(TC_THREADS)
    decode_split_tc(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                    const Rows rows, const int* __restrict__ cur, T* __restrict__ out, int H,
                    int KV, int window, float scale_log2, int split_len, int bk) {
  constexpr int P = Tc<D>::PITCH, KD = D / 16, ND = D / 8, CPR = D * 2 / 16;
  extern __shared__ __align__(16) unsigned char dt_smem[];
  const int g = H / KV, n_mt = (g + TC_ROWS - 1) / TC_ROWS;
  const int ns = Tc<D>::stages(split_len);    // ring slot: stage % TC_STAGES < ns
  T* Qs = reinterpret_cast<T*>(dt_smem);      // [16][P]
  T* Ks = Qs + TC_ROWS * P;                   // [ns][TC_SR][P]
  T* Vs = Ks + ns * TC_SR * P;                // [ns][TC_SR][P]
  int* Pos = reinterpret_cast<int*>(Vs + ns * TC_SR * P);   // [ns][TC_SR]

  const int b = blockIdx.x / (KV * n_mt), kh = blockIdx.x / n_mt % KV, mt = blockIdx.x % n_mt;
  const int h0 = kh * g + mt * TC_ROWS, gt = min(TC_ROWS, g - mt * TC_ROWS);
  const int split = blockIdx.y, n_split = gridDim.y;
  const int S = rows.length();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cur_b = cur[b];
  const int s_begin = split * split_len, s_end = min(S, s_begin + split_len);
  const int n_st = (s_end - s_begin + TC_SR - 1) / TC_SR;

  // the tile's query rows (zeros past its gt heads)
  for (int i = tid; i < TC_ROWS * CPR; i += TC_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool in = r < gt;
    cp_async16(smem_addr(Qs + r * P + c), q + (in ? ((long long)b * H + h0 + r) * D + c : 0),
               in);
  }
  // one stage of TC_SR slots into ring slot st % TC_STAGES; slots past the
  // split are zero rows, past in the scores
  auto issue = [&](int st) {
    const int s0 = s_begin + st * TC_SR, slot = st % TC_STAGES;
    T* ks = Ks + slot * TC_SR * P;
    T* vs = Vs + slot * TC_SR * P;
    for (int i = tid; i < TC_SR * CPR; i += TC_THREADS) {
      const int r = i / CPR, c = (i % CPR) * 8, s = s0 + r;
      const bool in = s < s_end;
      long long off = 0;
      if (in) {
        const int c0 = s - s % bk;
        off = rows.chunk(b, c0, D).base + ((long long)(s - c0) * KV + kh) * D + c;
      }
      cp_async16(smem_addr(ks + r * P + c), kc + off, in);
      cp_async16(smem_addr(vs + r * P + c), vc + off, in);
    }
    int* ps = Pos + slot * TC_SR;
    for (int i = tid; i < TC_SR; i += TC_THREADS) {
      const int s = s0 + i, c0 = s - s % bk;
      const Chunk ch = s < s_end ? rows.chunk(b, c0, D) : Chunk{0, nullptr, false};
      if (ch.mapped)
        cp_async4(smem_addr(ps + i), ch.pos + (s - c0));
      else
        ps[i] = -1;   // masked (an unmapped page); past the split by index
    }
  };
  if (n_st > 0) issue(0);
  cp_async_commit();

  // the warp's online softmax over its 16 slots of every stage: o (16 x D,
  // mma accumulator layout), m and l of the thread's rows lane/4 and
  // lane/4 + 8, in log2 units
  float o[ND][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.0f;
  const uint32_t qa = smem_addr(Qs + (lane % 16) * P + (lane / 16) * 8);

  for (int t = 0; t < n_st; ++t) {
    if (t + 1 < n_st) issue(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // stage t (and Qs) visible to all
    const int slot = t % TC_STAGES, j0 = warp * 16;
    const T* Kt = Ks + (slot * TC_SR + j0) * P;
    const T* Vt = Vs + (slot * TC_SR + j0) * P;
    const int* pw = Pos + slot * TC_SR + j0;
    const int sw = s_begin + t * TC_SR + j0;   // the warp's first slot

    // S = Q·Kᵀ: A from Q rows (x4: rows 0-15 x k 0-15), B from K rows, the
    // columns of Kᵀ (x4: two 8-slot n-tiles x two k halves)
    float sc[2][4] = {};
    const uint32_t ka = smem_addr(Kt + (lane % 8 + (lane / 16) * 8) * P + ((lane / 8) % 2) * 8);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4], bb[4];
      ldmatrix_x4(a, qa + kk * 16 * 2);
      ldmatrix_x4(bb, ka + kk * 16 * 2);
      mma16816<T>(sc[0], a, bb[0], bb[1]);
      mma16816<T>(sc[1], a, bb[2], bb[3]);
    }
    // scale and mask, then each row's new running max across its quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = (lane % 4) * 2 + nt * 8 + (e & 1);
        const float x = sw + j >= s_end ? -INFINITY
                        : slot_valid(pw[j], cur_b, window) ? sc[nt][e] * scale_log2
                                                           : kNegInf;
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);   // m starts at -1e30: never -inf
      corr[r] = exp2_approx(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
    // O += P·V: the two n-tiles' weights are one A fragment of P (16 slots),
    // rounded once to T; B from V rows by ldmatrix.trans
    uint32_t a[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float p0 = exp2_approx(sc[nt][0] - m[0]), p1 = exp2_approx(sc[nt][1] - m[0]);
      const float p2 = exp2_approx(sc[nt][2] - m[1]), p3 = exp2_approx(sc[nt][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      a[2 * nt] = pack2<T>(p0, p1);
      a[2 * nt + 1] = pack2<T>(p2, p3);
    }
    const uint32_t va = smem_addr(Vt + (lane % 8 + ((lane / 8) % 2) * 8) * P + (lane / 16) * 8);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= corr[0];
      o[nd][1] *= corr[0];
      o[nd][2] *= corr[1];
      o[nd][3] *= corr[1];
    }
#pragma unroll
    for (int dp = 0; dp < ND / 2; ++dp) {
      uint32_t bb[4];
      ldmatrix_x4_trans(bb, va + dp * 16 * 2);
      mma16816<T>(o[2 * dp], a, bb[0], bb[1]);
      mma16816<T>(o[2 * dp + 1], a, bb[2], bb[3]);
    }
    __syncthreads();   // this ring slot is free
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // the quad's four partial denominators
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // merge the four warps in warp order, in the rings' memory
  float* Mw = reinterpret_cast<float*>(Ks);   // [TC_WARPS][16]
  float* Lw = Mw + TC_WARPS * TC_ROWS;        // [TC_WARPS][16]
  float* Ow = Lw + TC_WARPS * TC_ROWS;        // [TC_WARPS][16][D]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = lane / 4 + 8 * r;
    if (lane % 4 == 0) {
      Mw[warp * TC_ROWS + row] = m[r];
      Lw[warp * TC_ROWS + row] = l[r];
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int c = nd * 8 + (lane % 4) * 2;
      Ow[(warp * TC_ROWS + row) * D + c] = o[nd][2 * r];
      Ow[(warp * TC_ROWS + row) * D + c + 1] = o[nd][2 * r + 1];
    }
  }
  __syncthreads();
  // the block's partial: each (row, column) merged by one thread in place of
  // warp 0's, m and l beside; or the output
  float* Pm = Ow + TC_WARPS * TC_ROWS * D;    // [16]
  float* Pl = Pm + TC_ROWS;                   // [16]
  float* F = Pl + TC_ROWS;                    // the merge's scratch
  T* ob = out + ((long long)b * H + h0) * D;
  for (int i = tid; i < gt * D; i += TC_THREADS) {
    const int r = i / D, c = i % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) mm = fmaxf(mm, Mw[w * TC_ROWS + r]);
    float ll = 0.0f, acc = 0.0f;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) {
      const float f = exp2_approx(Mw[w * TC_ROWS + r] - mm);
      ll += Lw[w * TC_ROWS + r] * f;
      acc += Ow[(w * TC_ROWS + r) * D + c] * f;
    }
    if (n_split == 1) {
      ob[r * D + c] = from_f32<T>(acc / fmaxf(ll, 1e-30f));
      continue;
    }
    Ow[r * D + c] = acc;
    if (c == 0) {
      Pm[r] = mm;
      Pl[r] = ll;
    }
  }
  if (n_split > 1) cluster_combine<T, TC_THREADS>(Ow, Pm, Pl, D, gt, ob, D, n_split, F);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The launch arguments every instance shares.
template <typename Rows>
struct Launch {
  const void *q, *k, *v;
  Rows rows;
  const int* cur;
  void* out;
  int B, H, KV, window;
  float scale_log2;
  int n_split, split_len;
  cudaStream_t s;
};

// grid (x, n_split), a cluster of the n_split blocks along y
template <typename Kernel, typename... Args>
cudaError_t launch_clustered(Kernel* kernel, unsigned x, int n_split, int threads, int smem,
                             cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(x, n_split);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = n_split;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int D, int BK, typename Rows>
cudaError_t launch_f32(const Launch<Rows>& a) {
  using Sh = Simt<D, BK>;
  static bool ready[kMaxDevices] = {};
  cudaError_t err = allow_dynamic_smem(decode_split_simt<D, BK, Rows>,
                                       Sh::smem_bytes(DA_GMAX, DA_STAGES), ready);
  if (err != cudaSuccess) return err;
  const int smem = Sh::smem_bytes(a.H / a.KV, Sh::stages(a.split_len));
  return launch_clustered(decode_split_simt<D, BK, Rows>, a.B * a.KV, a.n_split, DA_THREADS,
                          smem, a.s, static_cast<const float*>(a.q),
                          static_cast<const float*>(a.k), static_cast<const float*>(a.v), a.rows,
                          a.cur, static_cast<float*>(a.out), a.H, a.KV, a.window, a.scale_log2,
                          a.split_len);
}

template <int D, typename T, typename Rows>
cudaError_t launch_tc(const Launch<Rows>& a, int bk) {
  static bool ready[kMaxDevices] = {};
  cudaError_t err = allow_dynamic_smem(decode_split_tc<D, T, Rows>,
                                       Tc<D>::smem_bytes(TC_STAGES), ready);
  if (err != cudaSuccess) return err;
  const int n_mt = (a.H / a.KV + TC_ROWS - 1) / TC_ROWS;
  const int smem = Tc<D>::smem_bytes(Tc<D>::stages(a.split_len));
  return launch_clustered(decode_split_tc<D, T, Rows>, a.B * a.KV * n_mt, a.n_split,
                          TC_THREADS, smem, a.s, static_cast<const T*>(a.q),
                          static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.rows,
                          a.cur, static_cast<T*>(a.out), a.H, a.KV, a.window, a.scale_log2,
                          a.split_len, bk);
}

// fp32, bf16 and fp16 (the registry rows' surface); chunks of 8, 16 or 64
// slots
template <int D, typename Rows>
cudaError_t launch_d(int dtype, int BK, const Launch<Rows>& a) {
  if (BK != 8 && BK != 16 && BK != DA_BKMAX) return cudaErrorInvalidValue;
  if (dtype == kBF16) return launch_tc<D, __nv_bfloat16>(a, BK);
  if (dtype == kF16) return launch_tc<D, __half>(a, BK);
  if (dtype != kF32) return cudaErrorInvalidValue;
  switch (BK) {
    case 8: return launch_f32<D, 8>(a);
    case 16: return launch_f32<D, 16>(a);
    default: return launch_f32<D, DA_BKMAX>(a);
  }
}

// The plan: n_split splits of chunks_per_split·BK slots that tile [0, S),
// none empty, at most a portable cluster's 8.
template <typename Rows>
int launch_dtype(int dtype, int D, int BK, const void* q, const void* k, const void* v,
                 const Rows& rows, const void* current, void* out, int B, int H, int KV,
                 int window, float scale, int n_split, int chunks_per_split, void* stream) {
  if (KV < 1 || H % KV != 0 || H / KV > DA_GMAX) return cudaErrorInvalidValue;
  const long long split_len = (long long)chunks_per_split * BK, S = rows.length();
  if (n_split < 1 || n_split > DA_MAX_SPLITS || chunks_per_split < 1 || S < 1 ||
      (n_split - 1) * split_len >= S || n_split * split_len < S)
    return cudaErrorInvalidValue;
  constexpr float kLog2e = 1.4426950408889634f;
  const Launch<Rows> a{q, k, v, rows, static_cast<const int*>(current), out, B, H, KV, window,
                       scale * kLog2e, n_split, (int)split_len,
                       static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 16: return launch_d<16>(dtype, BK, a);
    case 32: return launch_d<32>(dtype, BK, a);
    case 64: return launch_d<64>(dtype, BK, a);
    case 128: return launch_d<128>(dtype, BK, a);
    case 256: return launch_d<256>(dtype, BK, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace decode
}  // namespace repro
