// Per-op attention over (B, T, H, dh): forward and backward, with the bias
// built in-kernel from the 1-D (B, T) masks.
//
// Replaces keypoints_interpolation_transformer_tpu/ops/pallas/attention.py::
// _attn_kernel (forward) and _attn_bwd_kernel (backward):
//     out = softmax(q k^T / sqrt(dh) + bias) v           (per head)
//     NEG where kind is repeat-inc, key > query and mask[key] == 1;
//     + mask[key] when add_keypad;  + NEG where valid[key] == 0.
// The backward takes what the TPU kernel takes (q, k, v, g = dL/dout and
// the masks) and returns dq, dk, dv; it rebuilds the probabilities, so its
// autograd Function saves only the forward's inputs, as the JAX vjp does.
//
// What bounds it on an H100: float32 FFMA work.  The forward needs 4 B H
// T^2 dh FLOP (q k^T and p v) against 4 (B, T, D) tensors of traffic, T / 4
// FLOP per byte (32 at T = 128, 512 at T = 2048; the card's float32 balance
// is 20).  The backward needs 10 B H T^2 dh (the scores, g v^T, and the
// products of dq, dk and dv); these kernels do 18 (the forward again for out
// and the stats, and the scores and g v^T in both of their passes).  Design
// (the kernels are the attention cores of attention.cuh, which the sublayer
// kernels run too):
//   forward: one block per (query tile of 128, head, video), one query per
//     thread with q and the output in registers; keys and values stream
//     through shared memory in tiles of 64 with an online softmax, so no
//     (T, T) score tensor is written and T is free (the model's positional
//     table caps it at 2048);
//   backward, three launches: the forward again, into scratch, for out and
//     each row's softmax max and sum; the query-major pass (dq, and delta =
//     g . out per row); the key-major pass (dk, dv).
// Not copied from the TPU kernel: the key-major transposed scores, the head
// grouping of the wide softmax, the exp2 / log2(e) fold, the query padding
// to blocks of 512, and its backward cap of T <= 512 (with the XLA
// recompute above it and below T = 256 under float32).
#include "attention.cuh"
#include "common.cuh"

using namespace kit;

// q, k, v, out (B*T, H*DH) rows; mask, valid (B, T), either null where not
// read (mask: kind "all" without keypad; valid: every key real).  DH, the
// head width, is 1 to 512.
extern "C" int kit_attention(const void* q, const void* k, const void* v, const void* mask,
                             const void* valid, int B, int T, int H, int DH, int repeat_inc,
                             int add_keypad, void* out, void* stream) {
  const int D = H * DH;
  const AttnArgs a{(const float*)q, (const float*)k, (const float*)v, D,
                   (const float*)mask, (const float*)valid, (float*)out, D, nullptr,
                   B, T, H, repeat_inc, add_keypad};
  return attn_fwd(a, DH, (cudaStream_t)stream);
}

// dq, dk, dv (B*T, H*DH) from q, k, v, g = dL/dout and the masks as
// kit_attention took them.  scratch holds B*T*H*DH + 3*B*H*T floats (the
// rebuilt out, the softmax stats and delta).
extern "C" int kit_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                 const void* mask, const void* valid, int B, int T, int H,
                                 int DH, int repeat_inc, int add_keypad, void* dq, void* dk,
                                 void* dv, void* scratch, void* stream) {
  auto st = (cudaStream_t)stream;
  const int D = H * DH;
  float* out = (float*)scratch;                  // B*T x D
  float* stats = out + (size_t)B * T * D;        // B x H x T x 2
  float* delta = stats + (size_t)B * H * T * 2;  // B x H x T
  const AttnArgs a{(const float*)q, (const float*)k, (const float*)v, D,
                   (const float*)mask, (const float*)valid, out, D, stats,
                   B, T, H, repeat_inc, add_keypad};
  int rc = attn_fwd(a, DH, st);
  if (rc) return rc;
  return attn_bwd(a, DH, (const float*)g, (float*)dq, D, (float*)dk, (float*)dv, D, delta, st);
}
