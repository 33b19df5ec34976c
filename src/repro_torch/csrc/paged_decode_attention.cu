// paged_decode_attention: one query row per sequence against a KV cache that
// lives in a shared (N, bs, KV, d) block arena, read through (B, nb) block
// tables, one page per online-softmax chunk.
//
// Replaces the Pallas TPU kernel `paged_decode_attention`
// (src/repro/kernels/flash/decode_attention.py:200, body `_paged_kernel` at
// :149). The body is decode_attention.cuh's, shared with decode_attention.cu:
// with the chunk equal to the page, this equals decode_attention(bk=bs) on
// the gathered pages bit for bit.
#include "decode_attention.cuh"

// q (B, H, D) and out (B, H, D) contiguous; k/v arena (N, bs, KV, D) whose
// (bs, KV, D) rows are contiguous, `block_stride` elements apart (a layer's
// slice of a stacked arena reads in place); pos arena (N, bs) rows
// contiguous, `pos_stride` apart; block tables (B, nb) int32 contiguous, -1
// an unmapped page; current (B,) int32. The chunk is one page: bs is one of
// 8, 16, 32, 64.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_arena, const void* v_arena, const void* pos_arena,
    const void* block_tables, const void* current, void* out, int B, int H, int KV, int bs,
    int nb, int D, long long block_stride, long long pos_stride, int window, float scale,
    int dtype, void* stream) {
  using namespace repro::decode;
  const PagedRows rows{static_cast<const int*>(pos_arena),
                       static_cast<const int*>(block_tables), block_stride, pos_stride, bs, nb};
  return launch_dtype(dtype, D, bs, q, k_arena, v_arena, rows, current, out, B, H, KV,
                      window, scale, stream);
}
