// Whole transformer layers in the precision modes "high" (bf16x3) and
// "default" (one bf16 pass), one C entry each: the post-LN encoder layer
// (kit_enc_layer_tc) and the decoder layer (kit_dec_layer_tc: self-attention
// + LN1, cross-attention and, when asked, the FF tail).
//
// Replaces keypoints_interpolation_transformer_tpu/ops/pallas/layer_fused.py
// under those modes: _enc_kernel (enc_layer_high, enc_layer_default) and
// _dec_kernel (dec_layer_high, dec_layer_default), as _enc_fwd_pallas and
// _dec_fwd_pallas call them.  The contract, the TPU kernels' mode
// arithmetic:
//   * the scale log2(e) / sqrt(dh) multiplies Wq and bq in float32 before
//     anything is split (the wrapper folds it, with the weight planes), and
//     log2(e) multiplies the bias's keypad term, so the scores are in the
//     log2 domain and the softmax runs on exp2;
//   * every projection (q / k / v, the memory's k / v, the
//     out-projections, W1, W2) is x_hi W_hi + x_hi W_lo + x_lo W_hi at
//     "high" or x_hi W_hi at "default" (hi = bf16(x), lo = bf16(x - hi),
//     both rounded to nearest even), its float32 sum then + bias; an
//     activation is split once for all the products that read it;
//   * the scores of a head are k_hi q_hi^T + k_hi q_lo^T + k_lo q_hi^T,
//     three dots summed in float32, then + bias (NEG = -1e9, finite); the
//     softmax takes each row's max, exp2(s - max), the sum, and multiplies
//     by 1 / sum BEFORE it rounds the probabilities to one bf16 each, which
//     then multiply v_hi and v_lo as two dots ("default": one term each, p
//     and v in bf16), so a row whose keys are all blocked averages them;
//   * biases, residuals, LayerNorms and the exact-erf GELU stay float32.
// Not copied from the TPU kernel: the key-major score layout, the bb row
// batching, _head_group and the VMEM caps, and the stacked [hi | hi | lo]
// contraction (the same three terms; only the order of the float32 sums
// differs).
//
// What bounds it on an H100: the bf16 tensor cores.  The encoder layer is
// 2 D (4 D + 2 FF) FLOP per token of products plus 4 T D of attention (90
// GFLOP per call at B = 256, T = 128, D = 256, FF = 2048), three passes
// of it at "high" (about 0.27 ms at 989 TFLOP/s) and one at "default"; the
// decoder 2 D (8 D + 2 FF) + 8 T D.  Bytes are small beside that: the layer
// reads x (and the memory) and writes y, 1-2 KB a token, the weight planes
// stay in the 50 MB L2.
//
// Design.  A layer is one call of a short sequence of launches on the
// stream, each phase on the kernel that fits it, its intermediates in
// scratch the wrapper allocates (bf16 planes, and float32 where a
// LayerNorm or a residual reads them), never back in PyTorch:
//   1. split_kernel: x (and the memory) into hi / lo planes;
//   2. the projections on tc_gemm.cuh's tc_gemm_kernel (wgmma m64n128k16
//      from two consumer warpgroups, operands streamed by TMA through an
//      mbarrier ring, 128 x 128 output tiles): q / k / v in one product of
//      [Wq s | Wk | Wv] (the decoder's cross k / v from the memory, its
//      cross q from x1 in two more), the epilogue adding the bias and
//      splitting the result into the planes the attention core reads;
//   3. attn_mode_kernel (attn_modes.cuh): the attention core per (query block,
//      head, video) on mma.sync m16n8k16, writing the output's planes;
//   4. the out-projection on tc_gemm_kernel, its epilogue adding the bias
//      and the residual (float32); in the decoder, ln_fwd_kernel then makes
//      x1 = LN1(r) and its planes;
//   5. the FF tail: ffn_tc.cuh's ffn_tc_kernel, the FF sublayer's own
//      kernel in the mode (u and z in registers, gelu(u) the register A
//      operand of the second product; its FF split over tc_parts blocks
//      and ffn_finish_kernel at small batches), LN_in before it.
// Why not one launch a layer, as layer_fused.cu walks the float32 layer in
// one cluster per video: the phases want different blocks (the products a
// producer warpgroup and two consumer warpgroups with 200 KB of ring, the
// attention core four warps and a head's keys), each launch's grid fills
// the card at any batch without the cluster machinery (one 128-frame video
// runs its q / k / v on 6 SMs, its attention on 16, its FF on 32), and the
// float32 kernel's intermediates go through device memory (L2) between its
// phases as these do.  What it costs is a launch per phase (5 for an
// encoder layer, 11 for a decoder layer, one more each with the FF split),
// each a host call.
//
// The attention core (attn_mode_kernel) and the projection launcher sit in
// attn_modes.cuh, shared with the attention sublayer in a mode
// (attn_sublayer_modes.cu).
#include "attn_modes.cuh"
#include "common.cuh"
#include "ffn_tc.cuh"
#include "grad.cuh"
#include "int8.cuh"
#include "mma_bf16.cuh"
#include "tc_gemm.cuh"

using namespace kit;

namespace {

struct AttnW {          // one attention sublayer's weights in a mode
  const bf16 *wh, *wl;  // [Wq s | Wk | Wv] (D, 3D) planes, s = log2(e) / sqrt(dh)
  const float* b;       // [bq s | bk | bv] (3D)
  const bf16 *oh, *ol;  // Wo (D, D) planes
  const float* bo;      // (D)
};

struct FfW {  // the FF tail: W1^T (FF, D) and W2^T (D, FF) planes, LN_in before it
  const bf16 *w1h, *w1l, *w2h, *w2l;
  const float *b1, *b2, *g_in, *be_in, *g_out, *be_out;
  int FF, parts;
  float* partial;  // parts > 1: parts x M x D floats
};

#define KIT_CHECK(x) \
  if ((rc = (x)) != 0) return rc

// The FF tail (ffn_tc_kernel): y = LN_out(x1 + FF(x1)), x1 = LN_in(r).
template <int TN, int PASSES>
int ff_tail(const float* r, int M, int n, const FfW& f, float* y, cudaStream_t st) {
  const FfArgs p{r,      M,       n,       f.FF,     f.parts, nullptr, f.b1,    nullptr, f.b2,
                 f.g_in, f.be_in, f.g_out, f.be_out, y,       nullptr, nullptr, f.partial};
  return launch_tc<TN, PASSES>(p, f.w1h, f.w1l, f.w2h, f.w2l, st);
}

// The encoder layer's attention half: r = x + MHA(x) into fs (M D floats),
// through the planes of x, q / k / v and the attention output.
template <int TN, int PASSES>
int enc_attention(const float* x, int B, int T, int n, int H, const AttnW& at, const Masks& mk,
                  Planes xp, Planes qkv, Planes ap, float* fs, cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int M = B * T;
  const size_t MD = (size_t)M * D;
  int rc;
  KIT_CHECK(split_planes(x, MD, xp.hi, xp.lo, st));
  KIT_CHECK((project<PASSES, EPI_PLANES>(xp.hi, xp.lo, M, D, at.wh, at.wl, 3 * D, 3 * D,
                                         planes_out(qkv, at.b), st)));
  if (n < D)  // the columns past the heads, which the padded Wo reads as 0 * a
    KIT_CHECK((int)cudaMemsetAsync(ap.hi, 0, (PASSES == 3 ? 2 : 1) * MD * sizeof(bf16), st));
  KIT_CHECK(attend<PASSES>(core(qkv, 3 * D, offset(qkv, D), offset(qkv, 2 * D), 3 * D, mk, ap, D,
                                T, n / H),
                           B, H, st));
  return project<PASSES, EPI_RES>(ap.hi, ap.lo, M, D, at.oh, at.ol, D, D,
                                  res_out(fs, D, x, at.bo), st);
}

// The encoder layer (see the note at the top).  planes: 5 M D bf16 a plane
// (x, q / k / v, the attention output); fs: M D floats (r).
template <int TN, int PASSES>
int enc_layer(const float* x, int B, int T, int n, int H, const AttnW& at, const FfW& ff,
              const Masks& mk, float* y, bf16* planes, float* fs, cudaStream_t st) {
  const size_t MD = (size_t)B * T * 32 * TN;
  bf16* cur = planes;
  const Planes xp = carve<PASSES>(cur, MD), qkv = carve<PASSES>(cur, 3 * MD),
               ap = carve<PASSES>(cur, MD);
  int rc;
  KIT_CHECK((enc_attention<TN, PASSES>(x, B, T, n, H, at, mk, xp, qkv, ap, fs, st)));
  return ff_tail<TN, PASSES>(fs, B * T, n, ff, y, st);
}

// The encoder layer with its FF tail int8 (_enc_kernel's ff_int8): the
// attention half in the mode, then int8.cuh's ffn_int8_kernel (LN1, the
// int8 x int8 products with their GELU, LN2), the tail the float32 int8
// layer and the int8 FF sublayer compute.  planes and fs as enc_layer's;
// h: M FF floats (the GELU rows).
template <int TN, int PASSES>
int enc_layer_int8(const float* x, int B, int T, int n, int H, const AttnW& at, const FFInt8& q,
                   const float* g1, const float* be1, const float* g2, const float* be2,
                   const Masks& mk, float* y, bf16* planes, float* fs, float* h,
                   cudaStream_t st) {
  const size_t MD = (size_t)B * T * 32 * TN;
  bf16* cur = planes;
  const Planes xp = carve<PASSES>(cur, MD), qkv = carve<PASSES>(cur, 3 * MD),
               ap = carve<PASSES>(cur, MD);
  int rc;
  KIT_CHECK((enc_attention<TN, PASSES>(x, B, T, n, H, at, mk, xp, qkv, ap, fs, st)));
  return launch_int8<TN>(fs, B * T, n, q, g1, be1, g2, be2, y, h, st);
}

// The decoder layer.  planes: 10 M D bf16 a plane (x, the memory, the self
// q / k / v, the cross k / v, the attention output, x1, the cross q); fs:
// 3 M D floats (x + SA(x), x1 and, with the FF tail, r).  ff.w1h null: no
// FF tail, y = r.
template <int TN, int PASSES>
int dec_layer(const float* x, const float* mem, int B, int T, int n, int H, const AttnW& sa,
              const AttnW& ca, const float* g1, const float* be1, const FfW& ff,
              const Masks& sm, const Masks& cm, float* y, bf16* planes, float* fs,
              cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int M = B * T, dh = n / H;
  const size_t MD = (size_t)M * D;
  bf16* cur = planes;
  const Planes xp = carve<PASSES>(cur, MD), mp = carve<PASSES>(cur, MD),
               sqkv = carve<PASSES>(cur, 3 * MD), ckv = carve<PASSES>(cur, 2 * MD),
               ap = carve<PASSES>(cur, MD), x1p = carve<PASSES>(cur, MD),
               q2 = carve<PASSES>(cur, MD);
  float *r1 = fs, *x1 = fs + MD, *r = ff.w1h == nullptr ? y : fs + 2 * MD;
  int rc;
  KIT_CHECK(split_planes(x, MD, xp.hi, xp.lo, st));
  KIT_CHECK(split_planes(mem, MD, mp.hi, mp.lo, st));
  KIT_CHECK((project<PASSES, EPI_PLANES>(xp.hi, xp.lo, M, D, sa.wh, sa.wl, 3 * D, 3 * D,
                                         planes_out(sqkv, sa.b), st)));
  KIT_CHECK((project<PASSES, EPI_PLANES>(mp.hi, mp.lo, M, D, ca.wh + D,
                                         ca.wl == nullptr ? nullptr : ca.wl + D, 2 * D, 3 * D,
                                         planes_out(ckv, ca.b + D), st)));
  if (n < D)
    KIT_CHECK((int)cudaMemsetAsync(ap.hi, 0, (PASSES == 3 ? 2 : 1) * MD * sizeof(bf16), st));
  KIT_CHECK(attend<PASSES>(
      core(sqkv, 3 * D, offset(sqkv, D), offset(sqkv, 2 * D), 3 * D, sm, ap, D, T, dh), B, H,
      st));
  KIT_CHECK((project<PASSES, EPI_RES>(ap.hi, ap.lo, M, D, sa.oh, sa.ol, D, D,
                                      res_out(r1, D, x, sa.bo), st)));
  ln_fwd_kernel<TN><<<(M + BM - 1) / BM, NT, 0, st>>>(r1, g1, be1, M, n, x1, x1p.hi, x1p.lo);
  KIT_CHECK((int)cudaGetLastError());
  KIT_CHECK((project<PASSES, EPI_PLANES>(x1p.hi, x1p.lo, M, D, ca.wh, ca.wl, D, 3 * D,
                                         planes_out(q2, ca.b), st)));
  KIT_CHECK(attend<PASSES>(core(q2, D, ckv, offset(ckv, D), 2 * D, cm, ap, D, T, dh), B, H, st));
  KIT_CHECK((project<PASSES, EPI_RES>(ap.hi, ap.lo, M, D, ca.oh, ca.ol, D, D,
                                      res_out(r, D, x1, ca.bo), st)));
  if (ff.w1h == nullptr) return 0;
  return ff_tail<TN, PASSES>(r, M, n, ff, y, st);
}

#undef KIT_CHECK

// The arguments every entry checks: widths, heads, the mode's lo planes,
// the FF width and its split (as kit_ffn_tc checks them).
bool args_ok(int passes, int D, int n, int H, const AttnW& a, const FfW& f) {
  const bool lo = passes == 3;
  if (!(passes == 1 || passes == 3) || n > D || H <= 0 || n % H) return false;
  if (lo && (a.wl == nullptr || a.ol == nullptr)) return false;
  if (f.w1h == nullptr) return true;
  return f.FF > 0 && f.FF % 16 == 0 && (!lo || (f.w1l && f.w2l)) && f.parts >= 1 &&
         f.parts <= (f.FF + FC_TC - 1) / FC_TC && (f.parts == 1 || f.partial != nullptr);
}

AttnW attn_w(const void* wh, const void* wl, const void* b, const void* oh, const void* ol,
             const void* bo) {
  return AttnW{(const bf16*)wh, (const bf16*)wl, (const float*)b,
               (const bf16*)oh, (const bf16*)ol, (const float*)bo};
}

FfW ff_w(const void* w1h, const void* w1l, const void* b1, const void* w2h, const void* w2l,
         const void* b2, const void* g_in, const void* be_in, const void* g_out,
         const void* be_out, int FF, int parts, void* partial) {
  auto f = [](const void* v) { return (const float*)v; };
  return FfW{(const bf16*)w1h, (const bf16*)w1l, (const bf16*)w2h, (const bf16*)w2l,
             f(b1),            f(b2),            f(g_in),          f(be_in),
             f(g_out),         f(be_out),        FF,               parts,
             (float*)partial};
}

}  // namespace

// x (B, T, D) -> y (B, T, D): one encoder layer in mode passes (3 "high",
// 1 "default").  wh / wl: [Wq s | Wk | Wv] (D, 3D) bf16 planes with s =
// log2(e) / sqrt(n / H) folded into Wq, b = [bq s | bk | bv] (3D); oh / ol
// Wo (D, D) planes, bo; w1h / w1l = W1^T (FF, D) and w2h / w2l = W2^T (D,
// FF) planes (the lo planes null with passes 1), b1, b2, LN1 g1 / be1 and
// LN2 g2 / be2; parts the FF split of ffn_tc_kernel (1: none; else at
// most one part per 64-wide FF chunk, with parts x B T x D floats of
// partial).  mask, valid (B, T) may be null.  planes: 5 B T D bf16 a
// plane (passes 3: two planes); fs: B T D floats.  D is 128, 256, 384 or
// 512; n <= D the model's true width (the operands zero-padded; see
// common.cuh); FF a multiple of 16.
extern "C" int kit_enc_layer_tc(int passes, const void* x, int B, int T, int D, int n, int H,
                                int FF, int parts, const void* wh, const void* wl, const void* b,
                                const void* oh, const void* ol, const void* bo, const void* w1h,
                                const void* w1l, const void* b1, const void* w2h,
                                const void* w2l, const void* b2, const void* g1,
                                const void* be1, const void* g2, const void* be2,
                                const void* mask, const void* valid, int repeat_inc,
                                int add_keypad, void* y, void* planes, void* fs, void* partial,
                                void* stream) {
  const AttnW at = attn_w(wh, wl, b, oh, ol, bo);
  const FfW ff = ff_w(w1h, w1l, b1, w2h, w2l, b2, g1, be1, g2, be2, FF, parts, partial);
  if (w1h == nullptr || !args_ok(passes, D, n, H, at, ff)) return (int)cudaErrorInvalidValue;
  const Masks mk{(const float*)mask, (const float*)valid, repeat_inc, add_keypad};
  return by_width(D, [&](auto tn) {
    constexpr int TN = decltype(tn)::value;
    auto layer = passes == 3 ? enc_layer<TN, 3> : enc_layer<TN, 1>;
    return layer((const float*)x, B, T, n, H, at, ff, mk, (float*)y, (bf16*)planes, (float*)fs,
                 (cudaStream_t)stream);
  });
}

// x (B, T, D) -> y (B, T, D): one encoder layer in mode passes with its FF
// tail int8.  The attention weights as kit_enc_layer_tc takes them; w1q
// (FF, D) and w2q (D, FF) int8 in torch's Linear layout with their
// per-row scales w1s (FF) and w2s (D) (the "ff" form), b1, b2, LN1 g1 /
// be1 and LN2 g2 / be2 as kit_ffn_int8 takes them.  planes and fs as
// kit_enc_layer_tc's; h: B T FF floats.  FF a multiple of 4.
extern "C" int kit_enc_layer_int8_tc(int passes, const void* x, int B, int T, int D, int n, int H,
                                     int FF, const void* wh, const void* wl, const void* b,
                                     const void* oh, const void* ol, const void* bo,
                                     const void* w1q, const void* w1s, const void* b1,
                                     const void* w2q, const void* w2s, const void* b2,
                                     const void* g1, const void* be1, const void* g2,
                                     const void* be2, const void* mask, const void* valid,
                                     int repeat_inc, int add_keypad, void* y, void* planes,
                                     void* fs, void* h, void* stream) {
  auto f = [](const void* v) { return (const float*)v; };
  const AttnW at = attn_w(wh, wl, b, oh, ol, bo);
  const FfW none = ff_w(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, nullptr, 0, 1, nullptr);
  if (w1q == nullptr || w2q == nullptr || FF <= 0 || FF % 4 || !args_ok(passes, D, n, H, at, none))
    return (int)cudaErrorInvalidValue;
  const FFInt8 q{(const int8_t*)w1q, f(w1s), f(b1), (const int8_t*)w2q, f(w2s), f(b2), FF};
  const Masks mk{f(mask), f(valid), repeat_inc, add_keypad};
  return by_width(D, [&](auto tn) {
    constexpr int TN = decltype(tn)::value;
    auto layer = passes == 3 ? enc_layer_int8<TN, 3> : enc_layer_int8<TN, 1>;
    return layer(f(x), B, T, n, H, at, q, f(g1), f(be1), f(g2), f(be2), mk, (float*)y,
                 (bf16*)planes, (float*)fs, (float*)h, (cudaStream_t)stream);
  });
}

// x, mem (B, T, D) -> y (B, T, D): one decoder layer in mode passes.  s*
// the self-attention weights, c* the cross-attention ones, as
// kit_enc_layer_tc takes them (the q block of c*wh scaled too); g1 / be1
// LN1; w1h null means no FF tail (y = x1 + CA(x1, mem)), else the FF
// weights as kit_enc_layer_tc's with LN2 g2 / be2 and LN3 g3 / be3.
// smask / svalid and cmask / cvalid (B, T) build the self and cross bias
// and may be null.  planes: 10 B T D bf16 a plane; fs: 3 B T D floats;
// partial as kit_enc_layer_tc's.
extern "C" int kit_dec_layer_tc(int passes, const void* x, const void* mem, int B, int T, int D,
                                int n, int H, int FF, int parts, const void* swh,
                                const void* swl, const void* sb, const void* soh,
                                const void* sol, const void* sbo, const void* cwh,
                                const void* cwl, const void* cb, const void* coh,
                                const void* col, const void* cbo, const void* g1,
                                const void* be1, const void* w1h, const void* w1l,
                                const void* b1, const void* w2h, const void* w2l,
                                const void* b2, const void* g2, const void* be2,
                                const void* g3, const void* be3, const void* smask,
                                const void* svalid, int srepeat_inc, int sadd_keypad,
                                const void* cmask, const void* cvalid, int crepeat_inc,
                                int cadd_keypad, void* y, void* planes, void* fs,
                                void* partial, void* stream) {
  const AttnW sa = attn_w(swh, swl, sb, soh, sol, sbo), ca = attn_w(cwh, cwl, cb, coh, col, cbo);
  const FfW ff = ff_w(w1h, w1l, b1, w2h, w2l, b2, g2, be2, g3, be3, FF, parts, partial);
  if (!args_ok(passes, D, n, H, sa, ff) || !args_ok(passes, D, n, H, ca, ff) ||
      (w1h == nullptr && parts != 1))
    return (int)cudaErrorInvalidValue;
  const Masks sm{(const float*)smask, (const float*)svalid, srepeat_inc, sadd_keypad};
  const Masks cm{(const float*)cmask, (const float*)cvalid, crepeat_inc, cadd_keypad};
  return by_width(D, [&](auto tn) {
    constexpr int TN = decltype(tn)::value;
    auto layer = passes == 3 ? dec_layer<TN, 3> : dec_layer<TN, 1>;
    return layer((const float*)x, (const float*)mem, B, T, n, H, sa, ca, (const float*)g1,
                 (const float*)be1, ff, sm, cm, (float*)y, (bf16*)planes, (float*)fs,
                 (cudaStream_t)stream);
  });
}
