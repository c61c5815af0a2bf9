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
// at any T):
//   1. with post_ln, dr = LN'(dy) (ln_bwd, one warp per row), else dr = dy;
//   2. da = dr Wo^T (rows_matmul);
//   3. attn_bwd_dq: one query per thread, keys streamed: delta = da . a per
//      (row, head), p rebuilt, dp = da . v, ds = p (dp - delta), dq = scale
//      sum ds k; writes dq into dqkv (B*T, 3D) and delta;
//   4. attn_bwd_dkv: one key per thread, queries streamed: dv = sum p da,
//      dk = scale sum ds q; writes dk, dv into dqkv;
//   5. the weight gradients dWqkv^T = dqkv^T [x | m], dWo^T = dr^T a and the
//      bias gradients (column sums) by the shared products of grad.cuh,
//      per row range then summed in a fixed order (no atomics);
//   6. dx = dr + dqkv Wqkv^T (self), or dx = dr + dq Wq^T and dmem = [dk dv]
//      [Wk Wv]^T (cross), by rows_matmul.
// Not copied from the TPU kernel: the key-major transposed scores, the
// exp2 / log2(e) fold, and its T <= 512 cap (keys and queries stream, so T
// is free).
#include "attention.cuh"
#include "common.cuh"
#include "grad.cuh"

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

template <int TN>
int launch_bwd(int n, const float* dy, const float* x, const float* mem, const float* qkv,
               const float* a, const float* stats, const float* r, const float* w_in,
               const float* w_out, const float* gamma, const float* mask, const float* valid,
               int B, int T, int H, int repeat_inc, int add_keypad, int s_w, int s_vec, float* dx,
               float* dmem, float* dw_in, float* db_in, float* dw_out, float* db_out,
               float* ln_out, float* scratch, cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int M = B * T, blocks = (M + BM - 1) / BM;
  const bool self = mem == nullptr;
  const float* m = self ? x : mem;
  float* dr_buf = scratch;                               // M x D
  float* da = dr_buf + (size_t)M * D;                    // M x D
  float* dqkv = da + (size_t)M * D;                      // M x 3D
  float* delta = dqkv + (size_t)M * 3 * D;               // B x H x T
  float* p_ln = delta + round_up(B * H * T, 4);          // blocks x 2D
  float* p_wq = p_ln + (size_t)blocks * 2 * D;           // s_w x D x D
  float* p_wkv = p_wq + (size_t)s_w * D * D;             // s_w x 2D x D
  float* p_wo = p_wkv + (size_t)s_w * 2 * D * D;         // s_w x D x D
  float* p_bin = p_wo + (size_t)s_w * D * D;             // s_vec x 3D
  float* p_bo = p_bin + (size_t)s_vec * 3 * D;           // s_vec x D
  int rc;
#define KIT_CHECK(x) \
  if ((rc = (x)) != 0) return rc
  const float* dr = dy;
  if (gamma != nullptr) {
    ln_bwd_kernel<TN><<<blocks, NT, 0, st>>>(dy, r, gamma, M, n, dr_buf, p_ln);
    KIT_CHECK((int)cudaGetLastError());
    KIT_CHECK(sum_parts(p_ln, blocks, 2 * D, ln_out, st));
    dr = dr_buf;
  }
  KIT_CHECK(rows_matmul<TN>(dr, D, D, w_out, D, nullptr, M, da, st));  // da = dr Wo^T
  // the attention core's gradients: dq, dk, dv into dqkv's three parts (the
  // backward only reads a and stats)
  KIT_CHECK(attn_bwd(core_args(qkv, D, mask, valid, const_cast<float*>(a),
                               const_cast<float*>(stats), B, T, H, repeat_inc, add_keypad),
                     n / H, da, dqkv, 3 * D, dqkv + D, dqkv + 2 * D, 3 * D, delta, st));
  // weight gradients in torch's layout: dW_in[j, i] = sum_r dqkv[r, j] m[r, i]
  KIT_CHECK(atb<false>(dqkv, 3 * D, x, D, M, D, D, s_w, p_wq, dw_in, st));
  KIT_CHECK(atb<false>(dqkv + D, 3 * D, m, D, M, 2 * D, D, s_w, p_wkv, dw_in + (size_t)D * D,
                       st));
  KIT_CHECK(atb<false>(dr, D, a, D, M, D, D, s_w, p_wo, dw_out, st));
  KIT_CHECK(colsum(dqkv, 3 * D, M, 3 * D, s_vec, p_bin, db_in, st));
  KIT_CHECK(colsum(dr, D, M, D, s_vec, p_bo, db_out, st));
  if (self) {
    KIT_CHECK(rows_matmul<TN>(dqkv, 3 * D, 3 * D, w_in, D, dr, M, dx, st));
  } else {
    KIT_CHECK(rows_matmul<TN>(dqkv, 3 * D, D, w_in, D, dr, M, dx, st));
    KIT_CHECK(rows_matmul<TN>(dqkv + D, 3 * D, 2 * D, w_in + (size_t)D * D, D, nullptr, M, dmem,
                              st));
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
// 5 M D + B H T (rounded up to 4) + blocks * 2 D + s_w * 4 D^2 +
// s_vec * 4 D floats, M = B*T, blocks = ceil(M / 32).  D and n as
// kit_attn_sublayer takes them.
extern "C" int kit_attn_sublayer_bwd(const void* dy, const void* x, const void* mem,
                                     const void* qkv, const void* a, const void* stats,
                                     const void* r, const void* w_in, const void* w_out,
                                     const void* gamma, const void* mask, const void* valid,
                                     int B, int T, int D, int n, int H, int repeat_inc,
                                     int add_keypad, int s_w, int s_vec, void* dx, void* dmem,
                                     void* dw_in, void* db_in, void* dw_out, void* db_out,
                                     void* ln_out, void* scratch, void* stream) {
  auto st = (cudaStream_t)stream;
  auto p = [](const void* v) { return (const float*)v; };
  auto o = [](void* v) { return (float*)v; };
  if (H <= 0 || n > D || n % H) return (int)cudaErrorInvalidValue;
  return by_width(D, [&](auto tn) {
    return launch_bwd<decltype(tn)::value>(
        n, p(dy), p(x), p(mem), p(qkv), p(a), p(stats), p(r), p(w_in), p(w_out), p(gamma),
        p(mask), p(valid), B, T, H, repeat_inc, add_keypad, s_w, s_vec, o(dx), o(dmem),
        o(dw_in), o(db_in), o(dw_out), o(db_out), o(ln_out), o(scratch), st);
  });
}
