// One post-LN attention sublayer of the transformer: forward (three
// launches, with the training residuals when asked) and backward.
//
// Replaces keypoints_interpolation_transformer_tpu/ops/pallas/
// attn_sublayer.py::_sublayer_kernel and _sublayer_train_kernel:
//     q = x Wq + bq;  k = m Wk + bk;  v = m Wv + bv        (m = x or memory)
//     a = softmax(q k^T / sqrt(dh) + bias) v                (per head)
//     r = x + a Wo + bo;  y = LN(r) if post_ln else r
// and _sublayer_bwd_kernel (its gradients).  The bias is built in-kernel
// from the 1-D (B, T) frame and valid masks (ops/pallas/attention.py::
// _bias_terms), by the same expression in every kernel here, so the
// backward sees the forward's bias bit for bit:
//     NEG where kind is repeat-inc, key > query and mask[key] == 1;
//     + mask[key] when add_keypad;  + NEG where valid[key] == 0.
//
// What bounds it on an H100: at D = 256, 8 heads of 32 the four projections
// are 0.52 MFLOP per token of float32 FFMA work and the attention core
// 0.13 MFLOP per token at T = 128 (the backward about twice each); the
// (B, H, T, T) scores would be 34 MB per sublayer at B = 64, T = 128 if
// they were written.  Forward design, and what passes through device
// memory between the launches:
//   1. qkv_proj: one product of the block's 32 rows against the packed
//      [Wq | Wk | Wv] (D, 3D) weight, one D-wide column block per grid.y;
//      writes qkv (B*T, 3D).
//   2. attn_fwd_kernel (attention.cuh, shared with the per-op attention
//      kernel): one block per (query tile of 128, head, batch row), one
//      query per thread with q and the output in registers; keys and values
//      stream through shared memory in tiles of 64 with an online softmax,
//      so no (T, T) score tensor is ever written; writes a (B*T, D) and, in
//      training, each (row, head)'s softmax max and sum (stats).
//   3. out_proj: a Wo + bo + x, then the optional LayerNorm over the full
//      D-wide row (one warp per row) in the same block; writes y and, in
//      training, the pre-LN r.
// The training forward keeps qkv, a, stats and r; its q is the unscaled
// projection.  The log-sum-exp is kept as its two parts: m + log(l) rounds
// away log(l) when m = NEG (a row whose keys are all blocked), and the
// backward would then rebuild probabilities of 1 instead of 1 / l.
//
// Backward design (the TPU kernel keeps a (T, H*T) probability residual
// when it fits VMEM and otherwise rebuilds it; here every probability is
// rebuilt from q, k, the bias and the stats, so no (T, T) tensor is stored
// at any T).  Its products, 16 M D^2 FLOP (8.6 GFLOP at the flagship's B =
// 64, T = 128), run on sgemm.cuh's 8 x 8 core with both operands streamed
// (sgemm_grad.cuh), the attention core's 5 B H T^2 dh on attention_grad.cuh's
// one-pass core:
//   1. with post_ln, dr = LN'(dy) (ln_bwd, one warp per row), else dr = dy;
//   2. da = dr Wo^T (nn);
//   3. one pass over each (video, head, 128 keys): delta = da . a, P
//      rebuilt, dP, dS, dv, dk and dq (attention_grad.cuh: head widths 16,
//      32, 64; other widths keep attention.cuh's two passes), written into
//      dqkv (M, 3D);
//   4. [dWqkv^T | dWo^T] = [dqkv^T [x | m] | dr^T a] in one launch (tn) per
//      row range, with the bias gradients (dqkv's and dr's column sums) on
//      the way, the ranges added in a fixed order (sum_split);
//   5. dx = dr + dqkv Wqkv^T (self), or dx = dr + dq Wq^T and dmem = [dk dv]
//      [Wk Wv]^T (cross) (nn).
// No sum uses atomics: the gradients have the same bits from run to run.
// Not copied from the TPU kernel: the key-major transposed scores, the
// exp2 / log2(e) fold, and its T <= 512 cap (keys and queries stream, so T
// is free).
#include "attention.cuh"
#include "attention_grad.cuh"
#include "common.cuh"
#include "grad.cuh"
#include "sgemm_grad.cuh"

using namespace kit;

namespace {

template <int TN>
__global__ void __launch_bounds__(NT)
qkv_proj_kernel(const float* __restrict__ x, const float* __restrict__ mem, int M,
                const float* __restrict__ wqkv, const float* __restrict__ bqkv,
                float* __restrict__ qkv) {
  constexpr int D = 32 * TN;
  extern __shared__ __align__(16) float smem[];
  float* AT = smem;            // D x LDT, k-major rows
  float* Ws = smem + D * LDT;  // BK x D
  const int row0 = blockIdx.x * BM, part = blockIdx.y;  // 0: q, 1: k, 2: v
  stage_rows(AT, part == 0 ? x : mem, D, row0, M, D);
  __syncthreads();
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  mma_rows<TN>(acc, AT, D, wqkv + part * D, 3 * D, D, Ws);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] += __ldg(bqkv + part * D + col_of(j));
  store_rows<TN>(qkv + part * D, 3 * D, D, row0, M, acc);
}

template <int TN>
__global__ void __launch_bounds__(NT)
out_proj_kernel(const float* __restrict__ a, const float* __restrict__ x, int M, int n,
                const float* __restrict__ wo, const float* __restrict__ bo,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                float* __restrict__ y, float* __restrict__ r_out) {
  constexpr int D = 32 * TN;
  extern __shared__ __align__(16) float smem[];
  float* AT = smem;            // D x LDT, k-major rows
  float* Ws = smem + D * LDT;  // BK x D
  const int row0 = blockIdx.x * BM;
  stage_rows(AT, a, D, row0, M, D);
  __syncthreads();
  float r[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) r[i][j] = 0.f;
  mma_rows<TN>(r, AT, D, wo, D, D, Ws);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int row = row0 + row_of(i);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int c = col_of(j);
      float xr = row < M ? __ldg(x + (size_t)row * D + c) : 0.f;
      r[i][j] = xr + (r[i][j] + __ldg(bo + c));
    }
  }
  if (gamma != nullptr) {
    if (r_out != nullptr) store_rows<TN>(r_out, D, D, row0, M, r);
    layer_norm<TN>(r, gamma, beta, n);
  }
  store_rows<TN>(y, D, D, row0, M, r);
}

// The attention core's view of the packed qkv (B*T, 3D) rows and the
// attention output a (B*T, D).
AttnArgs core_args(const float* qkv, int D, const float* mask, const float* valid, float* a,
                   float* stats, int B, int T, int H, int repeat_inc, int add_keypad) {
  return {qkv, qkv + D, qkv + 2 * D, 3 * D, mask, valid, a, D, stats, B, T, H, repeat_inc,
          add_keypad};
}

// n: the model's true width (<= D; see common.cuh), n / H the head width.
template <int TN>
int launch_rows(const float* x, const float* mem, int M, int n, const float* wqkv,
                const float* bqkv, const float* wo, const float* bo, const float* gamma,
                const float* beta, float* qkv, float* a, float* y, float* stats, float* r_out,
                int B, int T, int H, int repeat_inc, int add_keypad, const float* mask,
                const float* valid, cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int smem = (D * LDT + BK * D) * sizeof(float);
  static bool ready_qkv = false, ready_out = false;
  cudaError_t e = allow_smem(qkv_proj_kernel<TN>, smem, ready_qkv);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(out_proj_kernel<TN>, smem, ready_out);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (M + BM - 1) / BM;

  qkv_proj_kernel<TN><<<dim3(blocks, 3), NT, smem, st>>>(x, mem, M, wqkv, bqkv, qkv);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;

  rc = attn_fwd(core_args(qkv, D, mask, valid, a, stats, B, T, H, repeat_inc, add_keypad), n / H,
                st);
  if (rc) return rc;

  out_proj_kernel<TN><<<blocks, NT, smem, st>>>(a, x, M, n, wo, bo, gamma, beta, y, r_out);
  return (int)cudaGetLastError();
}

// The backward (see the note at the top); scratch as kit_attn_sublayer_bwd
// lays it out.
template <int TN>
int launch_bwd(int n, const float* dy, const float* x, const float* mem, const float* qkv,
               const float* a, const float* stats, const float* r, const float* w_in,
               const float* w_out, const float* gamma, const float* mask, const float* valid,
               int B, int T, int H, int repeat_inc, int add_keypad, int s_w, float* dx,
               float* dmem, float* dw_in, float* db_in, float* dw_out, float* db_out,
               float* ln_out, float* scratch, cudaStream_t st) {
  constexpr int D = 32 * TN, BR = row_tile(D);
  const int M = B * T, blocks = (M + BM - 1) / BM;
  const bool self = mem == nullptr;
  const float* m = self ? x : mem;
  float* dr_buf = scratch;                               // M x D
  float* da = dr_buf + (size_t)M * D;                    // M x D
  float* dqkv = da + (size_t)M * D;                      // M x 3D
  float* delta = dqkv + (size_t)M * 3 * D;               // B x H x T
  float* p_ln = delta + round_up(B * H * T, 4);          // blocks x 2D
  float* p_w = p_ln + (size_t)blocks * 2 * D;            // s_w x (4 D^2 + 4 D)
  float* dq_part = p_w + (size_t)s_w * (4 * D * D + 4 * D);  // key_tiles(T) x M x D, if > 1
  int rc;
#define KIT_CHECK(x) \
  if ((rc = (x)) != 0) return rc
  const float* dr = dy;
  if (gamma != nullptr) {
    ln_bwd_kernel<TN><<<blocks, NT, 0, st>>>(dy, r, gamma, M, n, dr_buf, p_ln);
    KIT_CHECK((int)cudaGetLastError());
    KIT_CHECK(sum_split(p_ln, blocks, 2 * D, 2 * D, ln_out, st));
    dr = dr_buf;
  }
  // da = dr Wo^T (w_out in torch's layout: rows o, columns i)
  KIT_CHECK((nn<BR, D>(NNArgs{dr, D, M, D, w_out, D, D, da, D, nullptr, 0, nullptr, 0}, st)));
  // the attention core's gradients into dqkv's three parts; a narrower
  // model (n < D) leaves each part's columns from n on unwritten, and the
  // products below read them (times zero weights): zero them first
  if (n < D) KIT_CHECK((int)cudaMemsetAsync(dqkv, 0, (size_t)M * 3 * D * sizeof(float), st));
  KIT_CHECK(attn_grad(core_args(qkv, D, mask, valid, const_cast<float*>(a),
                                const_cast<float*>(stats), B, T, H, repeat_inc, add_keypad),
                      n / H, da, dqkv, 3 * D, dqkv + D, dqkv + 2 * D, 3 * D, delta, dq_part, st));
  // [dW_in^T | dW_out^T | db_in | db_out]: dW_in[j, i] = sum_r dqkv[r, j]
  // m[r, i] (q from x), dW_out[o, i] = sum_r dr[r, o] a[r, i], the bias
  // gradients the column sums of dqkv and dr
  const size_t DD = (size_t)D * D;
  TNArgs w{};
  int np = 0;
  if (self) {
    w.p[np++] = TNProduct{dqkv, 3 * D, 3 * D, x, D, 0, 0, 1, 0, 4 * DD, D};
  } else {
    w.p[np++] = TNProduct{dqkv, 3 * D, D, x, D, 0, 0, 1, 0, 4 * DD, D};
    w.p[np++] = TNProduct{dqkv + D, 3 * D, 2 * D, m, D, 0, 0, 1, DD, 4 * DD + D, D};
  }
  w.p[np++] = TNProduct{dr, D, D, a, D, 0, 0, 1, 3 * DD, 4 * DD + 3 * D, D};
  w.np = np;
  w.K = M;
  w.ncols = D;
  w.part = p_w;
  w.split = 4 * DD + 4 * D;
  KIT_CHECK((tn<BR, D>(w, s_w, st)));
  KIT_CHECK(sum_split(p_w, s_w, w.split, 3 * D * D, dw_in, st));
  KIT_CHECK(sum_split(p_w + 3 * DD, s_w, w.split, D * D, dw_out, st));
  KIT_CHECK(sum_split(p_w + 4 * DD, s_w, w.split, 3 * D, db_in, st));
  KIT_CHECK(sum_split(p_w + 4 * DD + 3 * D, s_w, w.split, D, db_out, st));
  // dx = dr + dqkv W_in (self: K = 3D), or dr + dq W_q and dmem = [dk dv] W_kv
  const NNArgs dxa{dqkv, 3 * D, M, self ? 3 * D : D, w_in, D, D, dx, D, dr, D, nullptr, 0};
  KIT_CHECK((nn<BR, D>(dxa, st)));
  if (!self) {
    const NNArgs dma{dqkv + D, 3 * D, M, 2 * D, w_in + DD, D, D, dmem, D, nullptr, 0, nullptr,
                     0};
    KIT_CHECK((nn<BR, D>(dma, st)));
  }
#undef KIT_CHECK
  return 0;
}

}  // namespace

// x, mem (B*T, D) -> y (B*T, D).  qkv (B*T, 3D) and a (B*T, D) are buffers
// the caller allocates (the training residuals q, k, v and a).  mask, valid
// (B, T) may be null (no keypad / repeat-inc term, all keys valid); gamma,
// beta null means no LayerNorm.  stats (B, H, T, 2) and r_out (B*T, D), when
// not null, receive each (row, head)'s softmax max and sum and the pre-LN
// sum.  D is 128, 256, 384 or 512; n <= D is the model's true width (the
// operands zero-padded from n to D; see common.cuh) and n / H, the head
// width, a multiple of 4 up to 512.  a must hold zeros in columns H * (n /
// H) and up when n < D.
extern "C" int kit_attn_sublayer(const void* x, const void* mem, int B, int T, int D, int n,
                                 int H, const void* wqkv, const void* bqkv, const void* wo,
                                 const void* bo, const void* gamma, const void* beta,
                                 const void* mask, const void* valid, int repeat_inc,
                                 int add_keypad, void* qkv, void* a, void* y, void* stats,
                                 void* r_out, void* stream) {
  auto st = (cudaStream_t)stream;
  auto p = [](const void* v) { return (const float*)v; };
  auto o = [](void* v) { return (float*)v; };
  if (H <= 0 || n > D || n % H) return (int)cudaErrorInvalidValue;
  return by_width(D, [&](auto tn) {
    return launch_rows<decltype(tn)::value>(p(x), p(mem), B * T, n, p(wqkv), p(bqkv), p(wo),
                                            p(bo), p(gamma), p(beta), o(qkv), o(a), o(y),
                                            o(stats), o(r_out), B, T, H, repeat_inc, add_keypad,
                                            p(mask), p(valid), st);
  });
}

// Gradients of kit_attn_sublayer's y given dy = dL/dy (B*T, D), the
// forward's inputs and its residuals qkv, a, stats and r (r with a
// LayerNorm only).  mem null means self-attention (dmem is then unused);
// w_in (3D, D) and w_out (D, D) are in torch's layout (W^T of the Flax
// weights).  Writes dx, dmem, dw_in (3D, D), db_in (3D), dw_out (D, D),
// db_out (D) and, with gamma, ln_out = [dgamma | dbeta].  scratch holds
// 5 M D + B H T (rounded up to 4) + blocks * 2 D + s_w * (4 D^2 + 4 D)
// floats, and key_tiles(T) M D more where the head width takes the
// one-pass core (tiled_head) and T > AB_KT; M = B*T, blocks = ceil(M /
// 32); the weight and bias gradients sum over s_w row ranges.  D and n as
// kit_attn_sublayer takes them.
extern "C" int kit_attn_sublayer_bwd(const void* dy, const void* x, const void* mem,
                                     const void* qkv, const void* a, const void* stats,
                                     const void* r, const void* w_in, const void* w_out,
                                     const void* gamma, const void* mask, const void* valid,
                                     int B, int T, int D, int n, int H, int repeat_inc,
                                     int add_keypad, int s_w, void* dx, void* dmem,
                                     void* dw_in, void* db_in, void* dw_out, void* db_out,
                                     void* ln_out, void* scratch, void* stream) {
  auto st = (cudaStream_t)stream;
  auto p = [](const void* v) { return (const float*)v; };
  auto o = [](void* v) { return (float*)v; };
  if (H <= 0 || n > D || n % H || s_w < 1) return (int)cudaErrorInvalidValue;
  return by_width(D, [&](auto tn) {
    return launch_bwd<decltype(tn)::value>(
        n, p(dy), p(x), p(mem), p(qkv), p(a), p(stats), p(r), p(w_in), p(w_out), p(gamma),
        p(mask), p(valid), B, T, H, repeat_inc, add_keypad, s_w, o(dx), o(dmem),
        o(dw_in), o(db_in), o(dw_out), o(db_out), o(ln_out), o(scratch), st);
  });
}
