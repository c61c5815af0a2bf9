// Per-op attention over (B, T, H, dh): forward and backward, with the bias
// built in-kernel from the 1-D (B, T) masks.
//
// Replaces keypoints_interpolation_transformer_tpu/ops/pallas/attention.py::
// _attn_kernel (forward) and _attn_bwd_kernel (backward):
//     out = softmax(q k^T / sqrt(dh) + bias) v           (per head)
//     NEG where kind is repeat-inc, key > query and mask[key] == 1;
//     + mask[key] when add_keypad;  + NEG where valid[key] == 0.
// The forward may also write each (video, head, query)'s softmax max and
// sum, stats (B, H, T, 2); the backward takes q, k, v, g = dL/dout, the
// masks and, where the caller kept them, the forward's out and stats (the
// autograd Function saves both), and returns dq, dk, dv.  Without them it
// runs the forward into scratch first, as the TPU kernel, which rebuilds
// the probabilities from q, k, v alone, does.
//
// What bounds it on an H100: float32 FFMA work.  The forward needs 4 B H
// T^2 dh FLOP (q k^T and p v) against 4 (B, T, D) tensors of traffic, T / 4
// FLOP per byte (32 at T = 128, 512 at T = 2048; the card's float32 balance
// is 20).  The backward needs 10 B H T^2 dh (the scores, g v^T, and the
// products of dq, dk and dv), given out and stats.  Design, at the head
// widths 16, 32 and 64 (tiled_head):
//   forward (attention_fwd.cuh): one block per (64 queries, head, video),
//     8 rows a warp; keys and values stream through a cp.async ring of 128
//     keys; q k^T and p v are register-tiled products (8 x 4 sums a lane),
//     the online softmax's row max and sum warp shuffles; T is free (the
//     model's positional table caps it at 2048);
//   backward (attention_grad.cuh, the core attn_sublayer_bwd runs): one
//     pass per (128 keys, head, video), dk and dv in registers, the queries
//     streamed 32 at a time, p rebuilt from the score and (m, l); dq written
//     once at T <= 128, else each key tile's part added in order by
//     dq_sum_kernel.  One launch group given out and stats, two without.
// At other head widths the forward is attention.cuh's attn_fwd_kernel (one
// query a thread) and the backward its two passes (query-major dq, then
// key-major dk and dv).
// Not copied from the TPU kernel: the key-major transposed scores, the head
// grouping of the wide softmax, the exp2 / log2(e) fold, the query padding
// to blocks of 512, and its backward cap of T <= 512 (with the XLA
// recompute above it and below T = 256 under float32).
#include "attention.cuh"
#include "attention_fwd.cuh"
#include "attention_grad.cuh"
#include "common.cuh"

using namespace kit;

// q, k, v, out (B*T, H*DH) rows; mask, valid (B, T), either null where not
// read (mask: kind "all" without keypad; valid: every key real); stats (B,
// H, T, 2) or null.  DH, the head width, is 1 to 512; at 16, 32 and 64 the
// rows are read as float4 (16-byte aligned).
extern "C" int kit_attention(const void* q, const void* k, const void* v, const void* mask,
                             const void* valid, int B, int T, int H, int DH, int repeat_inc,
                             int add_keypad, void* out, void* stats, void* stream) {
  const int D = H * DH;
  const AttnArgs a{(const float*)q, (const float*)k, (const float*)v, D,
                   (const float*)mask, (const float*)valid, (float*)out, D, (float*)stats,
                   B, T, H, repeat_inc, add_keypad};
  return attention_forward(a, DH, (cudaStream_t)stream);
}

// The floats of kit_attention_bwd's scratch, each part a multiple of 4 (16
// bytes): without the forward's out and stats, room for them; delta (B, H,
// T) where the head width takes the two passes; each key tile's dq part
// where it takes the one-pass core over more than one key tile.
static size_t bwd_scratch(int B, int T, int H, int DH, bool residuals) {
  const size_t BT = (size_t)B * T, rows = BT * H;
  size_t n = residuals ? 0 : BT * H * DH + round_up((int)(2 * rows), 4);
  if (!tiled_head(DH)) return n + round_up((int)rows, 4);
  const int tiles = key_tiles(T);
  return n + (tiles > 1 ? (size_t)tiles * BT * H * DH : 0);
}

// dq, dk, dv (B*T, H*DH) from q, k, v, g = dL/dout and the masks as
// kit_attention took them, and the forward's out and stats, or null (both):
// then the forward runs first, into scratch.  scratch holds
// bwd_scratch(B, T, H, DH, out != null) floats.
extern "C" int kit_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                 const void* mask, const void* valid, int B, int T, int H,
                                 int DH, int repeat_inc, int add_keypad, const void* out,
                                 const void* stats, void* dq, void* dk, void* dv,
                                 void* scratch, void* stream) {
  auto st = (cudaStream_t)stream;
  const int D = H * DH;
  if ((out == nullptr) != (stats == nullptr)) return (int)cudaErrorInvalidValue;
  float* sp = (float*)scratch;
  AttnArgs a{(const float*)q, (const float*)k, (const float*)v, D,
             (const float*)mask, (const float*)valid, (float*)out, D, (float*)stats,
             B, T, H, repeat_inc, add_keypad};
  if (out == nullptr) {
    a.out = sp;                                 // B*T x D
    a.stats = sp + (size_t)B * T * D;           // B x H x T x 2
    sp += bwd_scratch(B, T, H, DH, false) - bwd_scratch(B, T, H, DH, true);
    const int rc = attention_forward(a, DH, st);
    if (rc) return rc;
  }
  // delta (two passes) or the dq parts (one-pass core): bwd_scratch's rest
  return attn_grad(a, DH, (const float*)g, (float*)dq, D, (float*)dk, (float*)dv, D, sp, sp,
                   st);
}
