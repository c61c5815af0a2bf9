// The pre-stream chain with its embedding (kit_pre_embed_tc) and the post
// head (kit_post_head_tc) of the KeypointCompleter in the precision modes
// "high" (bf16x3) and "default" (one bf16 pass).
//
// Replaces keypoints_interpolation_transformer_tpu/ops/pallas/pointwise.py
// under those modes: _pre_embed_kernel (pre_stream_embed_high, _default)
// and _post_kernel (post_head_high, _default), as _pre_embed_pallas and
// _post_pallas call them.  The contract, the TPU kernels' mode arithmetic
// (_prep, _proj, _prep_weights: every product x_hi W_hi + x_hi W_lo + x_lo
// W_hi at "high" or x_hi W_hi at "default", hi = bf16(x), lo = bf16(x -
// hi) nearest even, its float32 sum then + bias; each activation split
// again before the product that reads it):
//   pre   e = x Wemb + bemb (x's F = 108 features zero-padded);
//         n = token_norm(e) [doubled for the Cycle residual] + (pe +
//         learned);  g = (n W1 + b1) * sigmoid(n W2 + b2);  s = g W3 + b3;
//         e is also an output (the post head's residual);
//   post  g from decoded as above;  z = token_norm((g W3 + b3) + f);
//         z = z * sigmoid(z);  out = z Wh + bh.
// token_norm, sigmoid, biases and the positional sum stay float32.
//
// What bounds it on an H100: the bf16 tensor cores at "high" (2 (F D + 3
// D^2) FLOP a token, three passes: 14.7 GFLOP x 3 a stream at B = 256, T =
// 128, D = 256, about 45 us at 989 TFLOP/s) and the bytes at "default" (x
// in, s and e out).
//
// Design: a short sequence of launches a chain, each on the kernel that
// fits it, as layer_modes.cu walks a layer: the products on tc_gemm.cuh's
// tc_gemm_kernel (wgmma fed by a TMA ring, 128 x 128 output tiles), whose
// epilogues add the bias (EPI_BIAS), add the bias and the residual f
// (EPI_RES), or gate the SwiGLU pair and split it (EPI_GLU: the weight
// planes of [W1 | W2] interleaved per 64 columns, so that one tile holds
// x1's and x2's same columns); the row steps (token_norm over a D-wide row,
// the positional sum, swish) in one warp a row, writing the planes the next
// product reads.  pre: split x, embed, norm, W12 + gate, W3 (5 launches);
// post: split decoded, W12 + gate, W3 + f, norm + swish, head (5).  The
// intermediates go through device memory (L2) in scratch the wrapper
// allocates.
// Not copied from the TPU kernel: the stacked [hi | hi | lo] contraction
// (the same three terms; only the float32 sum order differs), its padding
// of F to 128 lanes (to 112 here, the TMA row rule), the bb row batching.
#include "attn_modes.cuh"
#include "common.cuh"
#include "grad.cuh"
#include "mma_bf16.cuh"
#include "tc_gemm.cuh"

using namespace kit;

// (Kernels in namespace kit: see attention_modes.cu.)
namespace kit {

// The pre chain's row step: n = token_norm(e) (+ token_norm(e) with
// pe_residual) + pe[row % T], as hi / lo planes (row stride D = 32 TN).
template <int TN>
__global__ void __launch_bounds__(NT)
    pre_norm_kernel(const float* __restrict__ e, const float* __restrict__ pe, int M, int T,
                    int pe_residual, bf16* __restrict__ hi, bf16* __restrict__ lo) {
  constexpr int D = 32 * TN;
  const int row0 = blockIdx.x * BM;
  float v[TM][TN];
  load_rows<TN>(v, e, D, row0, M);
  row_norm<TN>(v);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + row_of(i);
    if (row >= M) continue;
    const float* pr = pe + (size_t)(row % T) * D;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float n = v[i][j];
      v[i][j] = (pe_residual ? n + n : n) + __ldg(pr + col_of(j));
    }
  }
  store_planes<TN>(hi, lo, row0, M, v);
}

// The post head's row step: z = token_norm(r), z * sigmoid(z), as hi / lo
// planes (row stride D = 32 TN).
template <int TN>
__global__ void __launch_bounds__(NT)
    post_norm_kernel(const float* __restrict__ r, int M, bf16* __restrict__ hi,
                     bf16* __restrict__ lo) {
  constexpr int D = 32 * TN;
  const int row0 = blockIdx.x * BM;
  float v[TM][TN];
  load_rows<TN>(v, r, D, row0, M);
  row_norm<TN>(v);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) v[i][j] = v[i][j] * sigmoidf(v[i][j]);
  store_planes<TN>(hi, lo, row0, M, v);
}

}  // namespace kit

namespace {

#define KIT_CHECK(x) \
  if ((rc = (x)) != 0) return rc

// F's padding: the planes' rows 16-byte aligned for TMA, the product's K a
// multiple of 16.
constexpr int pad_f(int F) { return (F + 15) / 16 * 16; }

struct SwiGluW {  // [W1 | W2] interleaved (D, 2D) and W3 (D, D) planes
  const bf16 *w12h, *w12l, *w3h, *w3l;
  const float *b12, *b3;
};

// g = (n W1 + b1) * sigmoid(n W2 + b2) from n's planes into g's.
template <int PASSES>
int gate(Planes n, int M, int D, const SwiGluW& w, Planes gp, cudaStream_t st) {
  GemmArgs p{};
  p.oh = gp.hi;
  p.ol = gp.lo;
  p.bias = w.b12;
  p.ldo = D;
  return project<PASSES, EPI_GLU>(n.hi, n.lo, M, D, w.w12h, w.w12l, 2 * D, 2 * D, p, st);
}

// x (M, F) -> s (M, D) and e (M, D).  planes: M (FP + 2 D) bf16 a plane.
template <int TN, int PASSES>
int pre_embed(const float* x, int M, int T, int F, const bf16* wembh, const bf16* wembl,
              const float* bemb, const float* pe, const SwiGluW& w, float* out, float* emb,
              int pe_residual, bf16* planes, cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int FP = pad_f(F);
  bf16* cur = planes;
  const Planes xp = carve<PASSES>(cur, (size_t)M * FP), np = carve<PASSES>(cur, (size_t)M * D),
               gp = carve<PASSES>(cur, (size_t)M * D);
  int rc;
  KIT_CHECK(split_rows(x, M, F, FP, xp.hi, xp.lo, st));
  GemmArgs pe_args{};
  pe_args.out = emb;
  pe_args.ldo = D;
  pe_args.bias = bemb;
  KIT_CHECK((project<PASSES, EPI_BIAS>(xp.hi, xp.lo, M, FP, wembh, wembl, D, D, pe_args, st)));
  pre_norm_kernel<TN><<<(M + BM - 1) / BM, NT, 0, st>>>(emb, pe, M, T, pe_residual, np.hi, np.lo);
  KIT_CHECK((int)cudaGetLastError());
  KIT_CHECK(gate<PASSES>(np, M, D, w, gp, st));
  GemmArgs so{};
  so.out = out;
  so.ldo = D;
  so.bias = w.b3;
  return project<PASSES, EPI_BIAS>(gp.hi, gp.lo, M, D, w.w3h, w.w3l, D, D, so, st);
}

// decoded, f (M, D) -> out (M, F).  planes: 3 M D bf16 a plane; fs: M D
// floats.
template <int TN, int PASSES>
int post_head(const float* dec, const float* f, int M, const SwiGluW& w, const bf16* whh,
              const bf16* whl, const float* bh, int F, float* out, bf16* planes, float* fs,
              cudaStream_t st) {
  constexpr int D = 32 * TN;
  const size_t MD = (size_t)M * D;
  bf16* cur = planes;
  const Planes dp = carve<PASSES>(cur, MD), gp = carve<PASSES>(cur, MD),
               zp = carve<PASSES>(cur, MD);
  int rc;
  KIT_CHECK(split_planes(dec, MD, dp.hi, dp.lo, st));
  KIT_CHECK(gate<PASSES>(dp, M, D, w, gp, st));
  KIT_CHECK((project<PASSES, EPI_RES>(gp.hi, gp.lo, M, D, w.w3h, w.w3l, D, D,
                                      res_out(fs, D, f, w.b3), st)));
  post_norm_kernel<TN><<<(M + BM - 1) / BM, NT, 0, st>>>(fs, M, zp.hi, zp.lo);
  KIT_CHECK((int)cudaGetLastError());
  // the head's planes (D, FP), its columns past F zero; out's rows F wide
  GemmArgs ho{};
  ho.M = M;
  ho.N = F;
  ho.K = D;
  ho.out = out;
  ho.ldo = F;
  ho.bias = bh;
  const int FP = pad_f(F);
  return tc_gemm_ld<PASSES, 0, EPI_BIAS>(zp.hi, zp.lo, M, D, D, whh, whl, D, FP, FP, ho, 1, st);
}

#undef KIT_CHECK

bool mode_ok(int passes, const SwiGluW& w, const void* lo) {
  if (passes == 1) return true;
  return passes == 3 && w.w12l != nullptr && w.w3l != nullptr && lo != nullptr;
}

SwiGluW swiglu_w(const void* w12h, const void* w12l, const void* b12, const void* w3h,
                 const void* w3l, const void* b3) {
  return SwiGluW{(const bf16*)w12h, (const bf16*)w12l, (const bf16*)w3h,
                 (const bf16*)w3l,  (const float*)b12, (const float*)b3};
}

}  // namespace

// x (M, F) -> out (M, D) and emb (M, D): the pre-stream chain in mode
// passes (3 "high", 1 "default").  wembh / wembl: Wemb (FP, D) planes, its
// rows past F zero (FP = F rounded up to 16); w12h / w12l: [W1 | W2] (D, 2D)
// planes, their columns interleaved per 64 (W1's 64 j .. 64 j + 63, then
// W2's); w3h / w3l: W3 (D, D) planes (the lo planes null with passes 1);
// bemb (D), b12 = [b1 | b2] (2D) as it is, b3 (D); pe (T, D) the positional
// table plus the learned vector, row m reading pe[m % T].  planes: M (FP +
// 2D) bf16 a plane.  D is 128, 256, 384 or 512, F a multiple of 4.
extern "C" int kit_pre_embed_tc(int passes, const void* x, int M, int T, int F, int D,
                                const void* wembh, const void* wembl, const void* bemb,
                                const void* pe, const void* w12h, const void* w12l,
                                const void* b12, const void* w3h, const void* w3l,
                                const void* b3, void* out, void* emb, int pe_residual,
                                void* planes, void* stream) {
  const SwiGluW w = swiglu_w(w12h, w12l, b12, w3h, w3l, b3);
  if (!mode_ok(passes, w, wembl) || F % 4 || F > D) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  return by_width(D, [&](auto tn) {
    constexpr int TN = decltype(tn)::value;
    auto f = passes == 3 ? pre_embed<TN, 3> : pre_embed<TN, 1>;
    return f((const float*)x, M, T, F, (const bf16*)wembh, (const bf16*)wembl,
             (const float*)bemb, (const float*)pe, w, (float*)out, (float*)emb, pe_residual,
             (bf16*)planes, (cudaStream_t)stream);
  });
}

// decoded, filled_emb (M, D) -> out (M, F): the post head in mode passes.
// w12 / w3 planes and biases as kit_pre_embed_tc takes them; whh / whl: Wh
// (D, FP) planes, its columns past F zero; bh (F).  planes: 3 M D bf16 a
// plane; fs: M D floats.
extern "C" int kit_post_head_tc(int passes, const void* dec, const void* f, int M, int D,
                                const void* w12h, const void* w12l, const void* b12,
                                const void* w3h, const void* w3l, const void* b3,
                                const void* whh, const void* whl, const void* bh, int F,
                                void* out, void* planes, void* fs, void* stream) {
  const SwiGluW w = swiglu_w(w12h, w12l, b12, w3h, w3l, b3);
  if (!mode_ok(passes, w, whl) || F % 4 || F > D) return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  return by_width(D, [&](auto tn) {
    constexpr int TN = decltype(tn)::value;
    auto fn = passes == 3 ? post_head<TN, 3> : post_head<TN, 1>;
    return fn((const float*)dec, (const float*)f, M, w, (const bf16*)whh, (const bf16*)whl,
              (const float*)bh, F, (float*)out, (bf16*)planes, (float*)fs,
              (cudaStream_t)stream);
  });
}
