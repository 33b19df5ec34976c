// decode_attention: one query row per sequence against a (B, S, KV, d) KV
// cache, online softmax over bk-slot chunks.
//
// Replaces the Pallas TPU kernel `decode_attention`
// (src/repro/kernels/flash/decode_attention.py:67, body `_kernel` at :29).
// The body, what it computes and what bounds it are in decode_attention.cuh,
// shared with paged_decode_attention.cu.
#include "decode_attention.cuh"

// q (B, H, D), k/v cache (B, S, KV, D), positions (B, S) int32, current (B,)
// int32, out (B, H, D): all contiguous. window <= 0: none. H / KV <= 32.
// bk: the chunk size, one of 8, 16, 32, 64.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* positions, const void* current, void* out,
                                       int B, int H, int KV, int S, int D, int window,
                                       float scale, int bk, int dtype, void* stream) {
  using namespace repro::decode;
  const MonoRows rows{static_cast<const int*>(positions), S, KV};
  return launch_dtype(dtype, D, bk, q, k, v, rows, current, out, B, H, KV, window, scale,
                      stream);
}
