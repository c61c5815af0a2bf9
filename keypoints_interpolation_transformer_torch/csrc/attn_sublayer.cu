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
// they were written.  Forward design, three launches, and what passes
// through device memory between them:
//   1. qkv_proj: a row tile's products against the packed [Wq | Wk | Wv]
//      (D, 3D) weight on sgemm.cuh's 8 x 8 core, rows k-major in shared
//      memory, the bias in the epilogue, q from x and k, v from m; writes
//      qkv (B*T, 3D).  Where row_tile(D) tiles fill the card (rows_fill)
//      a block runs its tile's three D-wide parts, staging the rows once
//      per source and the weights chained through the cp.async ring from
//      one part into the next (one product a block ran at 28 TFLOP/s, the
//      staging and the ring's fill exposed): bound by the core's
//      shared-memory reads.  Below that (one 128-frame video, M = 128) the
//      grid bounds it, so the tiles narrow to PROJ_ROWS x PROJ_COLS, one
//      a block: 24 blocks at M = 128 where 64-row tiles would give 2;
//   2. the attention core, attention_forward (attention_fwd.cuh, shared
//      with the per-op attention kernel): at head widths 16, 32 and 64 the
//      register-tiled core, one block per (64 queries, head, video), keys
//      and values streamed through a cp.async ring, q k^T and P V as
//      register-tiled products, an online softmax in warp shuffles (bound
//      by its shared-memory reads and the exps); other head widths
//      attention.cuh's one-query-a-thread core.  No (T, T) tensor is
//      written; writes a (B*T, D) and, in training, each (row, head)'s
//      softmax max and sum (stats) from the score expression the
//      backward's core rebuilds p from, so forward and backward agree on
//      p exactly;
//   3. out_proj: a Wo + bo + x on the same core (row_tile(D) rows, or
//      PROJ_ROWS at small M: a LayerNorm needs its whole row in the
//      block), then the optional LayerNorm over the full row, the sums
//      reaching its warp-per-row layout through shared memory; writes y
//      and, in training, the pre-LN r.
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
#include "attention_fwd.cuh"
#include "attention_grad.cuh"
#include "common.cuh"
#include "grad.cuh"
#include "sgemm.cuh"
#include "sgemm_grad.cuh"

using namespace kit;

namespace {

// The narrow tiles of the projections at small M (rows_fill false).
constexpr int PROJ_ROWS = 32;
constexpr int PROJ_COLS = 128;

// The geometry of a projection build: BM token rows times NP weight
// columns a block.  Shared memory: the rows k-major (D x LDA), then the
// weight ring of STAGES tiles of DEPTH x NP floats.
template <int TN, int BM_, int NP_>
struct ProjGeo {
  static constexpr int D = 32 * TN, BM = BM_, NP = NP_;
  static constexpr int LDA = BM + 4;  // keeps 16-byte rows and 4 LDA = 16 mod 32
  static constexpr int STAGES = ring_stages(D), DEPTH = BK;
  static constexpr int SMEM = (D * LDA + STAGES * DEPTH * NP) * (int)sizeof(float);
  using R = Ring<NP, DEPTH, STAGES>;
};

// qkv[:, p NP .. (p + 1) NP) = src Wqkv[:, p NP ..] + bqkv[p NP ..] for the
// block's PARTS column parts p from PARTS blockIdx.y on, src = x for the q
// columns (< D), else mem: the rows stage once per source, and each
// part's weight tiles load during the last steps of the part before.
template <int TN, int BM, int NP, int PARTS>
__global__ void __launch_bounds__(NT, 1)
    qkv_proj_kernel(const float* __restrict__ x, const float* __restrict__ mem, int M,
                    const float* __restrict__ wqkv, const float* __restrict__ bqkv,
                    float* __restrict__ qkv) {
  using G = ProjGeo<TN, BM, NP>;
  constexpr int D = G::D;
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;
  typename G::R ring{smem + D * G::LDA, 0};
  const int row0 = blockIdx.x * BM, p0 = blockIdx.y * PARTS;
  auto weight = [&](int p) {
    return p < p0 + PARTS ? Wt{wqkv + p * NP, 3 * D, NP, D} : Wt{};
  };
  ring.start(weight(p0), weight(p0 + 1));  // always chainable: K = D
  const float* staged = nullptr;
  for (int p = p0; p < p0 + PARTS; ++p) {
    const float* src = p * NP < D ? x : mem;
    if (src != staged) {  // Xs is free: block_mma ends with a barrier
      stage_kmajor<BM, G::LDA>(Xs, src, D, row0, M, D);
      __syncthreads();
      staged = src;
    }
    float acc[BM / 8][NP / 32];
    zero(acc);
    block_mma<BM, NP, G::LDA, G::DEPTH, G::STAGES>(acc, Xs, weight(p), weight(p + 1), ring);
    g_bias<BM, NP>(acc, bqkv + p * NP);
    g_store<BM, NP>(qkv + p * NP, 3 * D, row0, M, acc);
  }
}

// r = x + (a Wo + bo) over whole rows; y = LN(r) (r_out = r when not
// null) with gamma, else y = r.
template <int TN, int BM>
__global__ void __launch_bounds__(NT, 1)
    out_proj_kernel(const float* __restrict__ a, const float* __restrict__ x, int M, int n,
                    const float* __restrict__ wo, const float* __restrict__ bo,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    float* __restrict__ y, float* __restrict__ r_out) {
  using G = ProjGeo<TN, BM, 32 * TN>;
  using L = Mma<BM, G::D>;
  constexpr int D = G::D;
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.x * BM;
  const Wt w{wo, D, D, D};
  typename G::R ring{smem + D * G::LDA, 0};
  ring.start(w, Wt{});  // Wo's first tiles load while a stages
  stage_kmajor<BM, G::LDA>(smem, a, D, row0, M, D);
  __syncthreads();
  float r[BM / 8][TN];
  zero(r);
  block_mma<BM, D, G::LDA, G::DEPTH, G::STAGES>(r, smem, w, Wt{}, ring);
#pragma unroll
  for (int i = 0; i < L::RT; ++i) {
    const int row = row0 + L::row(i);
#pragma unroll
    for (int h = 0; h < L::CT / 4; ++h) {
      const int c = L::col(4 * h);
      float4 xr = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < M) xr = __ldg(reinterpret_cast<const float4*>(x + (size_t)row * D + c));
      r[i][4 * h] = xr.x + (r[i][4 * h] + __ldg(bo + c));
      r[i][4 * h + 1] = xr.y + (r[i][4 * h + 1] + __ldg(bo + c + 1));
      r[i][4 * h + 2] = xr.z + (r[i][4 * h + 2] + __ldg(bo + c + 2));
      r[i][4 * h + 3] = xr.w + (r[i][4 * h + 3] + __ldg(bo + c + 3));
    }
  }
  if (gamma == nullptr) {
    g_store<BM, D>(y, D, row0, M, r);
    return;
  }
  if (r_out != nullptr) g_store<BM, D>(r_out, D, row0, M, r);
  g_put<BM, D, G::LDA>(smem, r);  // into the LayerNorm's layout; Xs is free
  __syncthreads();
  float v[BM / 8][TN];
  get_rows<TN, G::LDA>(v, smem);
  layer_norm<TN>(v, gamma, beta, n);
  store_rows<TN>(y, D, D, row0, M, v);
}

template <int TN, int BM, int NP, int PARTS>
int launch_qkv(const float* x, const float* mem, int M, const float* wqkv, const float* bqkv,
               float* qkv, cudaStream_t st) {
  using G = ProjGeo<TN, BM, NP>;
  static bool ready = false;
  cudaError_t e = allow_smem(qkv_proj_kernel<TN, BM, NP, PARTS>, G::SMEM, ready);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BM - 1) / BM, 3 * G::D / (NP * PARTS));
  qkv_proj_kernel<TN, BM, NP, PARTS><<<grid, NT, G::SMEM, st>>>(x, mem, M, wqkv, bqkv, qkv);
  return (int)cudaGetLastError();
}

template <int TN, int BM>
int launch_out(const float* a, const float* x, int M, int n, const float* wo, const float* bo,
               const float* gamma, const float* beta, float* y, float* r_out, cudaStream_t st) {
  using G = ProjGeo<TN, BM, 32 * TN>;
  static bool ready = false;
  cudaError_t e = allow_smem(out_proj_kernel<TN, BM>, G::SMEM, ready);
  if (e != cudaSuccess) return (int)e;
  out_proj_kernel<TN, BM><<<(M + BM - 1) / BM, NT, G::SMEM, st>>>(a, x, M, n, wo, bo, gamma,
                                                                  beta, y, r_out);
  return (int)cudaGetLastError();
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
  constexpr int D = 32 * TN, BR = row_tile(D);
  if (M <= 0) return 0;
  const bool fill = rows_fill(M, D);
  int rc = fill ? launch_qkv<TN, BR, D, 3>(x, mem, M, wqkv, bqkv, qkv, st)
                : launch_qkv<TN, PROJ_ROWS, PROJ_COLS, 1>(x, mem, M, wqkv, bqkv, qkv, st);
  if (rc) return rc;
  rc = attention_forward(
      core_args(qkv, D, mask, valid, a, stats, B, T, H, repeat_inc, add_keypad), n / H, st);
  if (rc) return rc;
  return fill ? launch_out<TN, BR>(a, x, M, n, wo, bo, gamma, beta, y, r_out, st)
              : launch_out<TN, PROJ_ROWS>(a, x, M, n, wo, bo, gamma, beta, y, r_out, st);
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
