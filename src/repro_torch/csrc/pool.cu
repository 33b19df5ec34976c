// avg_pool / max_pool: NHWC window reductions.
//
// Replaces the Pallas TPU kernel `_pool_kernel` (src/repro/kernels/conv/pool.py:27,
// `pallas_call` in `_pool` at :44, entry points `avg_pool` :73 and
// `max_pool` :82). The TPU kernel keeps one padded image in VMEM and folds
// KH*KW strided tap slices. Here one block owns a tile of output pixels of
// one image (tile_h rows by tile_w columns) and a chunk of channels, as the
// host's plan says (kernels/conv/pool.py `pool_plan`; grid: batch x row tiles,
// column tiles, channel chunks). It stages the input patch those outputs read,
// ((tile_h-1)*SH + WH) rows by ((tile_w-1)*SW + WW) columns by the chunk, in
// shared memory: 16-byte cp.async where the plan picked the vector path
// (C * itemsize a multiple of 16, both pointers 16-byte aligned), scalar
// copies otherwise; cells outside the image hold the reduction's identity (0
// for avg, the engine's count-include-pad; -inf for max), so the SAME pads of
// `pad_explicit` apply without padding in device memory. All of a block's
// loads are in flight before the first wait, and each input byte crosses from
// device memory once per block; overlapping windows read their taps again
// from shared memory. Then each thread folds its output pixels' taps for the
// plan's fold of channels (16 bytes; 4 bytes where a block has few outputs,
// as at a global pool, so that more threads share its long fold; or one
// channel) from shared memory in (i, j) order: avg in fp32 from the first tap on, then __fmul_rn
// by the fp32 constant 1/(wh*ww) passed from the host (the reference
// multiplies, it does not divide), so the bits equal the plain version's;
// max exactly, NaN-propagating as jnp.maximum (a NaN on either side wins; a
// -inf pad never beats a finite value), 16-bit pairs with __hmax2_nan. One
// store in x's dtype. Index math is 32-bit from blockIdx/threadIdx: a division
// per block and per staged cell, none per output.
//
// What bounds it on an H100: device-memory bytes (each input read once, each
// output written once, at 3.35 TB/s); a window of wh*ww taps is that many
// operations per output, below the fp32 rate. A patch's halo (the rows and
// columns that neighbouring tiles also stage) is read again, from L2.
#include <type_traits>

#include "mma.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;

// NaN-propagating max: a NaN on either side wins (jnp.maximum's rule)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

struct PoolArgs {
  int H, W, C, OH, OW, WH, WW, SH, SW, PH, PW;  // geometry; PH, PW the low-side pads
  int chunk, tile_h, tile_w_log2, row_tiles;    // the plan
  int patch_h, patch_w;                         // staged rows and columns
  float inv;                                    // fp32 1/(WH*WW) (avg only)
};

// N values of T as one load: a scalar, 4 bytes or 16 bytes
template <typename T, int N>
using Vec = typename std::conditional<
    N == 1, T, typename std::conditional<N * sizeof(T) == 4, uint32_t, uint4>::type>::type;

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> splat(float v) {
  Vec<T, V> out;
  T* o = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int k = 0; k < V; ++k) o[k] = from_f32<T>(v);
  return out;
}

// the fold of one output pixel's V channels; avg and fp32 max in fp32,
// 16-bit max in packed pairs
template <typename T, int V, bool AVG>
struct Fold {
  static constexpr bool kPacked = !AVG && sizeof(T) == 2 && V > 1;
  using P2 = typename std::conditional<std::is_same<T, __half>::value, __half2,
                                       __nv_bfloat162>::type;
  float acc[kPacked ? 1 : V];
  P2 pair[kPacked ? V / 2 : 1];

  __device__ __forceinline__ void first(const Vec<T, V>& v) {
    if constexpr (kPacked) {
      const P2* p = reinterpret_cast<const P2*>(&v);
#pragma unroll
      for (int k = 0; k < V / 2; ++k) pair[k] = p[k];
    } else {
      const T* t = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = to_f32<T>(t[k]);
    }
  }

  __device__ __forceinline__ void add(const Vec<T, V>& v) {
    if constexpr (kPacked) {
      const P2* p = reinterpret_cast<const P2*>(&v);
#pragma unroll
      for (int k = 0; k < V / 2; ++k) pair[k] = __hmax2_nan(pair[k], p[k]);
    } else {
      const T* t = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int k = 0; k < V; ++k)
        acc[k] = AVG ? __fadd_rn(acc[k], to_f32<T>(t[k])) : max_nan(acc[k], to_f32<T>(t[k]));
    }
  }

  __device__ __forceinline__ Vec<T, V> result(float inv) const {
    Vec<T, V> out;
    if constexpr (kPacked) {
      P2* p = reinterpret_cast<P2*>(&out);
#pragma unroll
      for (int k = 0; k < V / 2; ++k) p[k] = pair[k];
    } else {
      T* t = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int k = 0; k < V; ++k) t[k] = from_f32<T>(AVG ? __fmul_rn(acc[k], inv) : acc[k]);
    }
    return out;
  }
};

template <typename T, bool AVG, int V, int FV>
__global__ void __launch_bounds__(kThreads)
    pool_kernel(const T* __restrict__ x, T* __restrict__ y, const PoolArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* patch = reinterpret_cast<T*>(smem_raw);
  // the block's image, first output row and column, and channel chunk
  const int b = blockIdx.x / a.row_tiles;
  const int oy0 = (blockIdx.x - b * a.row_tiles) * a.tile_h;
  const int ox0 = blockIdx.y << a.tile_w_log2;
  const int c0 = blockIdx.z * a.chunk;
  const int width = min(a.chunk, a.C - c0);  // the chunk's channels
  const T* img = x + static_cast<long long>(b) * a.H * a.W * a.C + c0;

  // stage the patch: cell (r, q) holds input row oy0*SH - PH + r, column
  // ox0*SW - PW + q, or the identity outside the image; a thread loads V
  // channels of every cell_step-th cell
  {
    const int threads = blockDim.x * blockDim.y, load_lanes = a.chunk / V;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int lc = (tid % load_lanes) * V, cell_step = threads / load_lanes;
    if (lc < width) {
      using VT = Vec<T, V>;
      const VT identity = splat<T, V>(AVG ? 0.0f : -INFINITY);
      const int iy0 = oy0 * a.SH - a.PH, ix0 = ox0 * a.SW - a.PW;
      const int cells = a.patch_h * a.patch_w;
      for (int cell = tid / load_lanes; cell < cells; cell += cell_step) {
        const int r = cell / a.patch_w, q = cell - r * a.patch_w;
        const int iy = iy0 + r, ix = ix0 + q;
        T* dst = patch + cell * a.chunk + lc;
        const bool in = iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
        if (!in) *reinterpret_cast<VT*>(dst) = identity;
        else if constexpr (V > 1)
          cp_async16(smem_addr(dst), img + (iy * a.W + ix) * a.C + lc, true);
        else *dst = img[(iy * a.W + ix) * a.C + lc];
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // fold: thread (tx, ty) takes FV channels from tx * FV of every rows-th
  // output pixel p of the tile, (p >> tile_w_log2, p & (tile_w - 1))
  using VT = Vec<T, FV>;
  const int c = threadIdx.x * FV, ty = threadIdx.y, rows = blockDim.y;
  if (c >= width) return;
  T* out = y + static_cast<long long>(b) * a.OH * a.OW * a.C + c0 + c;

  const int tile_w = 1 << a.tile_w_log2;
  const int taps = a.WH * a.WW;
  const int row_skip = (a.patch_w - a.WW) * a.chunk;  // from a window row's end to the next
  for (int p = ty; p < (a.tile_h << a.tile_w_log2); p += rows) {
    const int ry = p >> a.tile_w_log2, rx = p & (tile_w - 1);
    const int oy = oy0 + ry, ox = ox0 + rx;
    if (oy >= a.OH || ox >= a.OW) continue;
    const T* tap = patch + (ry * a.SH * a.patch_w + rx * a.SW) * a.chunk + c;
    Fold<T, FV, AVG> f;
    f.first(*reinterpret_cast<const VT*>(tap));
    int j = 1;
#pragma unroll 4
    for (int t = 1; t < taps; ++t) {
      tap += a.chunk;
      if (j == a.WW) {
        j = 0;
        tap += row_skip;
      }
      ++j;
      f.add(*reinterpret_cast<const VT*>(tap));
    }
    *reinterpret_cast<VT*>(out + (oy * a.OW + ox) * a.C) = f.result(a.inv);
  }
}

template <typename T, bool AVG, int V, int FV>
int launch(const void* x, void* y, const PoolArgs& a, int batch, int col_tiles, int n_chunks,
           cudaStream_t s) {
  const int lanes = a.chunk / FV;
  const dim3 grid(batch * a.row_tiles, col_tiles, n_chunks), block(lanes, kThreads / lanes);
  const int smem = a.patch_h * a.patch_w * a.chunk * static_cast<int>(sizeof(T));
  pool_kernel<T, AVG, V, FV><<<grid, block, smem, s>>>(static_cast<const T*>(x),
                                                       static_cast<T*>(y), a);
  return cudaGetLastError();
}

// (vec, fold): 16-byte loads folded 16 or 4 bytes at a time, or scalars
template <typename T, bool AVG>
int run(const void* x, void* y, const PoolArgs& a, int vec, int fold, int batch, int col_tiles,
        int n_chunks, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T), N = 4 / sizeof(T);
  if (vec == V && fold == V) return launch<T, AVG, V, V>(x, y, a, batch, col_tiles, n_chunks, s);
  if (vec == V && fold == N) return launch<T, AVG, V, N>(x, y, a, batch, col_tiles, n_chunks, s);
  if (vec == 1 && fold == 1) return launch<T, AVG, 1, 1>(x, y, a, batch, col_tiles, n_chunks, s);
  return cudaErrorInvalidValue;
}

template <bool AVG>
int run(const void* x, void* y, const PoolArgs& a, int vec, int fold, int batch, int col_tiles,
        int n_chunks, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return run<float, AVG>(x, y, a, vec, fold, batch, col_tiles, n_chunks, s);
  if (dtype == kBF16)
    return run<__nv_bfloat16, AVG>(x, y, a, vec, fold, batch, col_tiles, n_chunks, s);
  if (dtype == kF16) return run<__half, AVG>(x, y, a, vec, fold, batch, col_tiles, n_chunks, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (B, H, W, C) NHWC, y (B, OH, OW, C): contiguous, one dtype (code); PH, PW:
// the low-side explicit pads; inv: fp32 1/(WH*WW) (avg only); the plan of
// kernels/conv/pool.py `pool_plan`: vec (elements a load), fold (elements a
// thread folds), chunk (channels a block), tile_h, log2 tile_w, row_tiles,
// col_tiles, n_chunks, patch_h, patch_w. H*W*C and OH*OW*C below 2^31 (the
// wrapper checks).
#define REPRO_POOL_ENTRY(NAME, AVG)                                                            \
  extern "C" int NAME(const void* x, void* y, int B, int H, int W, int C, int OH, int OW,      \
                      int WH, int WW, int SH, int SW, int PH, int PW, int vec, int fold,       \
                      int chunk, int tile_h, int tile_w_log2, int row_tiles, int col_tiles,    \
                      int n_chunks, int patch_h, int patch_w, float inv, int dtype,            \
                      void* stream) {                                                          \
    const PoolArgs a{H,  W,     C,      OH,          OW,        WH,      WW,      SH, SW, PH, \
                     PW, chunk, tile_h, tile_w_log2, row_tiles, patch_h, patch_w, inv};        \
    return run<AVG>(x, y, a, vec, fold, B, col_tiles, n_chunks, dtype, stream);               \
  }

REPRO_POOL_ENTRY(avg_pool_launch, true)
REPRO_POOL_ENTRY(max_pool_launch, false)
