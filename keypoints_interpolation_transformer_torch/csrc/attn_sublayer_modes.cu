// One post-LN attention sublayer in the precision modes "high" (bf16x3) and
// "default" (one bf16 pass): the forward, in its serving and its training
// form (kit_attn_sublayer_tc), and the backward (kit_attn_sublayer_tc_bwd).
//
// Replaces keypoints_interpolation_transformer_tpu/ops/pallas/
// attn_sublayer.py under those modes: _sublayer_kernel
// (attn_sublayer_high, attn_sublayer_default), _sublayer_train_kernel
// (attn_sublayer_train_high / _default) and _sublayer_bwd_kernel
// (attn_sublayer_bwd_high / _default), as _fwd_pallas, _bwd_pallas and the
// custom VJP (_vjp_fwd / _vjp_bwd) call them.  The contract, the TPU
// kernels' mode arithmetic (see attn_modes.cuh for the split, the products
// and the softmax):
//   * serving: log2(e) / sqrt(dh) multiplies Wq and bq in float32 before
//     anything is split (the wrapper folds it into the weight planes, as
//     for the merged layers); every projection x_hi W_hi + x_hi W_lo + x_lo
//     W_hi ("high") or x_hi W_hi ("default"), then + bias; the core; the
//     out-projection, the residual and the optional LayerNorm in float32;
//   * training: Wq is not folded: q = x Wq + bq in the mode is kept in
//     float32 (the residual), and the core reads the planes of q times
//     log2(e) / sqrt(dh), scaled after the bias; q, k, v and a are kept in
//     float32, each row's softmax (m, l) in the log2 domain, and the pre-LN
//     sum r with a LayerNorm;
//   * backward: the LN backward in float32 (dr, dgamma, dbeta); dbo = sum
//     dr; dWo = a^T dr and dA = dr Wo^T from the planes; the core's dq, dk,
//     dv (attn_modes.cuh: p rebuilt from the statistics, the forward's very
//     p); per q, k, v the bias gradient (its column sum), dW = [x | m]^T
//     d[q | k | v] and dx = dr + dq Wq^T (+ dk Wk^T + dv Wv^T for
//     self-attention; else those two are dmem), every product of planes.
// Not copied from the TPU kernel: its residual / recompute split at T = 256
// (the probabilities are always rebuilt here, from each row's statistics:
// no (T, T) tensor reaches device memory at any T), its VMEM model, the
// key-major layout and the bb batching; nor its probability residual in
// bf16 (the rebuilt p is the same bf16 value).
//
// What bounds it on an H100: the bf16 tensor cores.  The forward is 8 M D^2
// FLOP of projections and 4 B H T^2 dh of attention (at "high" three
// passes of each but p v's two), the backward twice the projections and
// 5 B H T^2 dh of attention; bytes are small beside that (a token's rows
// in and out, the weight planes in L2).
//
// Design: a sequence of launches on the stream, the merged mode layers'
// pieces (layer_modes.cu), the intermediates as bf16 planes in scratch the
// wrapper allocates.  The forward (5 launches for self-attention with its
// LayerNorm, 6 for cross-attention without: one more split and one more
// projection):
//   1. split_kernel: x (and the memory) into hi / lo planes;
//   2. the projections on tc_gemm_kernel: serving, q / k / v in one product
//      of the folded Flax-layout planes [Wq s | Wk | Wv] (D, 3D) read
//      MN-major, the epilogue + bias and the split (EPI_PLANES); training,
//      of torch's in_proj_weight planes (3D, D) read K-major (the backward
//      reads the same planes MN-major: one split a step), the epilogue
//      writing float32 q, k, v and the planes of [q s | k | v] (EPI_QKV);
//      cross-attention q from x, k / v from the memory;
//   3. attn_mode_kernel: the core, its output as planes (and in float32
//      with the statistics in training);
//   4. the out-projection, + bo + x (EPI_RES): r, or y without a LayerNorm;
//   5. ln_fwd_kernel: y = LN(r).
// The backward (15 launches and a memset for self-attention with its
// LayerNorm, 17 for cross-attention without: the splits of dy and the
// memory and one more product each for dW and dx, less the LayerNorm's
// backward and sum):
//   1. ln_bwd_kernel (dr and its planes, per-block sums of dgamma and
//      dbeta, added by sum_split), or the split of dy;
//   2. the planes of x (and the memory) and of a (split_kernel);
//   3. dA's planes = dr Wo^T (tc_gemm_kernel, a zero bias);
//   4. attn_mode_dq_kernel, attn_mode_dkv_kernel into dqkv (M, 3D) float32,
//      then its planes;
//   5. [dW_in | dW_out] = [dqkv^T [x | m] | dr^T a] (tc_gemm_kernel, both
//      operands MN-major as they lie), over s_w row ranges added in order
//      (sum_split); the bias gradients [db_in | db_out], the column sums of
//      [dqkv | dr], per BIAS_ROWS rows (bias_grad_kernel), added in order;
//   6. dx = dr + dqkv W_in (EPI_ADD; cross-attention: dr + dq Wq and dmem =
//      [dk dv] W_kv).
// No sum uses atomics: the gradients have the same bits from run to run.
#include "attn_modes.cuh"
#include "common.cuh"
#include "grad.cuh"
#include "mma_bf16.cuh"
#include "sgemm_grad.cuh"
#include "tc_gemm.cuh"

using namespace kit;

// (A kernel in namespace kit: nvcc's registration stub cannot tell this
// file's anonymous namespace from kit's, which attn_modes.cuh opens.)
namespace kit {

// The bias gradients' partial sums: part[z * 4D + c] = the sum over rows
// [z BIAS_ROWS, (z + 1) BIAS_ROWS) of dqkv's column c (c < 3D) or of dr's
// column c - 3D; blockIdx.x a tile of 128 columns of [dqkv | dr], 4 a lane
// (16-byte loads), the 8 warps over the range's rows, then added in order of
// the warps.  sum_split then adds the ranges in order.
constexpr int BIAS_ROWS = 128;

__global__ void __launch_bounds__(NT) bias_grad_kernel(const float* __restrict__ dqkv,
                                                       const float* __restrict__ dr, int M, int D,
                                                       float* __restrict__ part) {
  __shared__ float4 red[NT / 32][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = 128 * blockIdx.x + 4 * lane;  // a column of [dqkv | dr]
  const bool q = c < 3 * D;
  const float* src = q ? dqkv + c : dr + (c - 3 * D);
  const int ld = q ? 3 * D : D, r1 = min(M, (int)(blockIdx.y + 1) * BIAS_ROWS);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = blockIdx.y * BIAS_ROWS + warp; r < r1; r += NT / 32) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src + (size_t)r * ld));
    s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0) return;
  float4 t = red[0][lane];
  for (int w = 1; w < NT / 32; ++w) {
    const float4 v = red[w][lane];
    t = make_float4(t.x + v.x, t.y + v.y, t.z + v.z, t.w + v.w);
  }
  *reinterpret_cast<float4*>(part + (size_t)blockIdx.y * 4 * D + c) = t;
}

}  // namespace kit

namespace {

struct SubW {           // the sublayer's weight planes and biases
  const bf16 *wh, *wl;  // serving: [Wq s | Wk | Wv] (D, 3D); training: W_in (3D, D)
  const float* b;       // (3D): serving [bq s | bk | bv], training [bq | bk | bv]
  const bf16 *oh, *ol;  // serving: Wo (D, D); training: W_out = Wo^T (D, D)
  const float* bo;      // (D)
};

GemmArgs qkv_out(float* out, int ldo, Planes o, const float* bias, int scols, float qs) {
  GemmArgs g{};
  g.out = out;
  g.ldo = ldo;
  g.oh = o.hi;
  g.ol = o.lo;
  g.bias = bias;
  g.scols = scols;
  g.qs = qs;
  return g;
}

Planes shift(Planes p, size_t elems) {
  return Planes{p.hi + elems, p.lo == nullptr ? nullptr : p.lo + elems};
}

#define KIT_CHECK(x) \
  if ((rc = (x)) != 0) return rc

// The forward (see the note at the top).  planes: (5 or, with a memory, 6)
// M D bf16 a plane (x, the memory, q / k / v, the attention output); fs: M D
// floats (r) when serving with a LayerNorm.  In training qkv (M, 3D), a32
// (M, D) and stats receive the residuals, r (M, D) the pre-LN sum with a
// LayerNorm.
template <int TN, int PASSES, int TB>
int forward(const float* x, const float* mem, int B, int T, int n, int H, const SubW& w,
            const float* gamma, const float* beta, const Masks& mk, float* y, float* qkv,
            float* a32, float* stats, float* r, bf16* planes, float* fs, cudaStream_t st) {
  constexpr int D = 32 * TN;
  constexpr bool TRAIN = TB == 0;
  const int M = B * T, dh = n / H;
  const size_t MD = (size_t)M * D;
  const bool self = mem == nullptr;
  bf16* cur = planes;
  const Planes xp = carve<PASSES>(cur, MD), mp = self ? xp : carve<PASSES>(cur, MD),
               qkvp = carve<PASSES>(cur, 3 * MD), ap = carve<PASSES>(cur, MD);
  // q's planes at row stride ldq, k's and v's at ldkv: one (M, 3D) block for
  // self-attention, else q (M, D) and [k | v] (M, 2D)
  const Planes kvp = self ? offset(qkvp, D) : shift(qkvp, MD);
  const int ldq = self ? 3 * D : D, ldkv = self ? 3 * D : 2 * D;
  const float qs = (float)(1.4426950408889634 / sqrt((double)dh));
  const size_t wrows = TRAIN ? (size_t)D * D : D;  // Wk's offset in the planes
  int rc;
  KIT_CHECK(split_planes(x, MD, xp.hi, xp.lo, st));
  if (!self) KIT_CHECK(split_planes(mem, MD, mp.hi, mp.lo, st));
  const int ldw = TRAIN ? D : 3 * D;
  const bf16* wkl = w.wl == nullptr ? nullptr : w.wl + wrows;
  if (TRAIN) {
    KIT_CHECK((project<PASSES, EPI_QKV, 0>(xp.hi, xp.lo, M, D, w.wh, w.wl, self ? 3 * D : D, ldw,
                                           qkv_out(qkv, 3 * D, qkvp, w.b, D, qs), st)));
    if (!self)
      KIT_CHECK((project<PASSES, EPI_QKV, 0>(mp.hi, mp.lo, M, D, w.wh + wrows, wkl, 2 * D, ldw,
                                             qkv_out(qkv + D, 3 * D, kvp, w.b + D, 0, qs), st)));
  } else {
    KIT_CHECK((project<PASSES, EPI_PLANES, 1>(xp.hi, xp.lo, M, D, w.wh, w.wl, self ? 3 * D : D,
                                              ldw, planes_out(qkvp, w.b), st)));
    if (!self)
      KIT_CHECK((project<PASSES, EPI_PLANES, 1>(mp.hi, mp.lo, M, D, w.wh + wrows, wkl, 2 * D, ldw,
                                                planes_out(kvp, w.b + D), st)));
  }
  if (n < D)  // the columns past the heads, which the padded Wo reads as 0 * a
    KIT_CHECK((int)cudaMemsetAsync(ap.hi, 0, (PASSES == 3 ? 2 : 1) * MD * sizeof(bf16), st));
  AttnMode c = core(qkvp, ldq, self ? offset(qkvp, D) : kvp,
                    self ? offset(qkvp, 2 * D) : offset(kvp, D), ldkv, mk, ap, D, T, dh);
  c.stats = stats;
  c.a32 = a32;
  KIT_CHECK(attend<PASSES>(c, B, H, st));
  float* sum = gamma == nullptr ? y : TRAIN ? r : fs;
  KIT_CHECK((project<PASSES, EPI_RES, TB>(ap.hi, ap.lo, M, D, w.oh, w.ol, D, D,
                                          res_out(sum, D, x, w.bo), st)));
  if (gamma == nullptr) return 0;
  ln_fwd_kernel<TN><<<(M + BM - 1) / BM, NT, 0, st>>>(sum, gamma, beta, M, n, y);
  return (int)cudaGetLastError();
}

// The backward (see the note at the top); scratch as
// kit_attn_sublayer_tc_bwd lays it out.
template <int TN, int PASSES>
int backward(const float* dy, const float* x, const float* mem, const float* qkv, const float* a,
             const float* stats, const float* r, const bf16* wih, const bf16* wil,
             const bf16* woh, const bf16* wol, const float* gamma, const Masks& mk, int B, int T,
             int n, int H, int s_w, float* dx, float* dmem, float* dw_in, float* dw_out,
             float* db, float* ln_out, float* scratch, cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int M = B * T, dh = n / H, blocks = (M + BM - 1) / BM,
            s_vec = (M + BIAS_ROWS - 1) / BIAS_ROWS;
  const size_t MD = (size_t)M * D, DD = (size_t)D * D;
  const bool self = mem == nullptr;
  float* dqkv = scratch;                                    // M x 3D
  float* delta = dqkv + 3 * MD;                             // B x H x T
  float* p_ln = delta + round_up(B * H * T, 4);             // blocks x 2D
  float* p_w = p_ln + (size_t)blocks * 2 * D;               // s_w x 4 D^2
  float* p_vec = p_w + (size_t)s_w * 4 * DD;                // s_vec x 4D
  float* zeros = p_vec + (size_t)s_vec * 4 * D;             // D
  float* dr_buf = zeros + D;                                // M x D
  bf16* cur = reinterpret_cast<bf16*>(dr_buf + MD);
  const Planes drp = carve<PASSES>(cur, MD), xp = carve<PASSES>(cur, MD),
               mp = self ? xp : carve<PASSES>(cur, MD), dap = carve<PASSES>(cur, MD),
               ap = carve<PASSES>(cur, MD), dqp = carve<PASSES>(cur, 3 * MD);
  int rc;
  const float* dr = dy;
  if (gamma != nullptr) {
    ln_bwd_kernel<TN><<<blocks, NT, 0, st>>>(dy, r, gamma, M, n, dr_buf, p_ln, drp.hi, drp.lo);
    KIT_CHECK((int)cudaGetLastError());
    KIT_CHECK(sum_split(p_ln, blocks, 2 * D, 2 * D, ln_out, st));
    dr = dr_buf;
  } else {
    KIT_CHECK(split_planes(dy, MD, drp.hi, drp.lo, st));
  }
  KIT_CHECK(split_planes(x, MD, xp.hi, xp.lo, st));
  if (!self) KIT_CHECK(split_planes(mem, MD, mp.hi, mp.lo, st));
  KIT_CHECK(split_planes(a, MD, ap.hi, ap.lo, st));
  // dA = dr W_out (torch's layout: rows o, columns i), as planes
  KIT_CHECK((int)cudaMemsetAsync(zeros, 0, D * sizeof(float), st));
  KIT_CHECK((project<PASSES, EPI_PLANES, 1>(drp.hi, drp.lo, M, D, woh, wol, D, D,
                                            planes_out(dap, zeros), st)));
  // the core's gradients into dqkv's three parts; a narrower model (n < D)
  // leaves each part's columns from n on unwritten, and the products below
  // read them: zero them first
  if (n < D) KIT_CHECK((int)cudaMemsetAsync(dqkv, 0, 3 * MD * sizeof(float), st));
  AttnModeBwd c{};
  c.q = qkv;
  c.k = qkv + D;
  c.v = qkv + 2 * D;
  c.ldqkv = 3 * D;
  c.dah = dap.hi;
  c.dal = dap.lo;
  c.a = a;
  c.ld = D;
  c.stats = stats;
  c.mask = mk.mask;
  c.valid = mk.valid;
  c.repeat_inc = mk.repeat_inc;
  c.add_keypad = mk.add_keypad;
  c.qs = (float)(1.4426950408889634 / sqrt((double)dh));
  c.scale = (float)(1.0 / sqrt((double)dh));
  c.dq = dqkv;
  c.dk = dqkv + D;
  c.dv = dqkv + 2 * D;
  c.ldg = 3 * D;
  c.delta = delta;
  c.T = T;
  c.dh = dh;
  KIT_CHECK(attend_bwd<PASSES>(c, B, H, st));
  KIT_CHECK(split_planes(dqkv, 3 * MD, dqp.hi, dqp.lo, st));
  // [dW_in | dW_out] per row range: dW_in[j, i] = sum_r dqkv[r, j] [x | m][r,
  // i] (q from x), dW_out[o, i] = sum_r dr[r, o] a[r, i]
  const size_t split = 4 * DD;
  GemmArgs g{};
  g.N = D;
  g.K = M;
  g.ldo = D;
  g.split = split;
  if (self) {
    g.M = 3 * D;
    g.out = p_w;
    KIT_CHECK((tc_gemm_ld<PASSES, 1, EPI_STORE>(dqp.hi, dqp.lo, M, 3 * D, 3 * D, xp.hi, xp.lo, M, D,
                                                D, g, s_w, st)));
  } else {
    g.M = D;
    g.out = p_w;
    KIT_CHECK((tc_gemm_ld<PASSES, 1, EPI_STORE>(dqp.hi, dqp.lo, M, D, 3 * D, xp.hi, xp.lo, M, D, D,
                                                g, s_w, st)));
    const Planes dkv = offset(dqp, D);
    g.M = 2 * D;
    g.out = p_w + DD;
    KIT_CHECK((tc_gemm_ld<PASSES, 1, EPI_STORE>(dkv.hi, dkv.lo, M, 2 * D, 3 * D, mp.hi, mp.lo, M,
                                                D, D, g, s_w, st)));
  }
  g.M = D;
  g.out = p_w + 3 * DD;
  KIT_CHECK((tc_gemm_ld<PASSES, 1, EPI_STORE>(drp.hi, drp.lo, M, D, D, ap.hi, ap.lo, M, D, D, g,
                                              s_w, st)));
  KIT_CHECK(sum_split(p_w, s_w, split, 3 * D * D, dw_in, st));
  KIT_CHECK(sum_split(p_w + 3 * DD, s_w, split, D * D, dw_out, st));
  bias_grad_kernel<<<dim3(D / 32, s_vec), NT, 0, st>>>(dqkv, dr, M, D, p_vec);
  KIT_CHECK((int)cudaGetLastError());
  KIT_CHECK(sum_split(p_vec, s_vec, 4 * D, 4 * D, db, st));
  // dx = dr + dqkv W_in (self: K = 3D), or dr + dq W_q and dmem = [dk dv] W_kv
  GemmArgs e{};
  e.M = M;
  e.N = D;
  e.K = self ? 3 * D : D;
  e.out = dx;
  e.ldo = D;
  e.add = dr;
  KIT_CHECK((tc_gemm_ld<PASSES, 0, EPI_ADD>(dqp.hi, dqp.lo, M, e.K, 3 * D, wih, wil, e.K, D, D, e,
                                            1, st)));
  if (!self) {
    const Planes dkv = offset(dqp, D);
    GemmArgs f{};
    f.M = M;
    f.N = D;
    f.K = 2 * D;
    f.out = dmem;
    f.ldo = D;
    KIT_CHECK((tc_gemm_ld<PASSES, 0, EPI_STORE>(dkv.hi, dkv.lo, M, 2 * D, 3 * D, wih + DD,
                                                wil == nullptr ? nullptr : wil + DD, 2 * D, D, D,
                                                f, 1, st)));
  }
  return 0;
}

#undef KIT_CHECK

}  // namespace

// x, mem (B*T, D) -> y (B*T, D): one attention sublayer in mode passes (3
// "high", 1 "default"); mem null means self-attention.  train 0 (serving):
// wh / wl = [Wq s | Wk | Wv] (D, 3D) bf16 planes with s = log2(e) / sqrt(n
// / H) folded into Wq, b = [bq s | bk | bv] (3D), oh / ol = Wo (D, D)
// planes (the Flax layout, as kit_enc_layer_tc takes them); qkv, a, stats
// and r unused.  train 1: wh / wl = in_proj_weight (3D, D) and oh / ol =
// out_proj.weight (D, D) planes in torch's layout, b = in_proj_bias (3D),
// unscaled; writes qkv (B*T, 3D) = [q | k | v] in float32 (q unscaled), a
// (B*T, D) float32 (its columns from n on as they were), stats (B, H, T, 2)
// each row's (m, l) of exp2 and, with gamma, r (B*T, D) the pre-LN sum.  The
// lo planes null with passes 1.  gamma, beta null means no LayerNorm; mask,
// valid (B, T) may be null.  planes: 5 B T D bf16 a plane (6 with a memory;
// passes 3: two planes); fs: B T D floats (serving with a LayerNorm; else
// unused).  D is 128, 256, 384 or 512; n <= D the model's true width (the
// operands zero-padded; see common.cuh).
extern "C" int kit_attn_sublayer_tc(int passes, int train, const void* x, const void* mem, int B,
                                    int T, int D, int n, int H, const void* wh, const void* wl,
                                    const void* b, const void* oh, const void* ol, const void* bo,
                                    const void* gamma, const void* beta, const void* mask,
                                    const void* valid, int repeat_inc, int add_keypad, void* y,
                                    void* qkv, void* a, void* stats, void* r, void* planes,
                                    void* fs, void* stream) {
  const bool lo = passes == 3;
  if (!(passes == 1 || passes == 3) || n > D || H <= 0 || n % H ||
      (lo && (wl == nullptr || ol == nullptr)) ||
      (train && (qkv == nullptr || a == nullptr || stats == nullptr ||
                 (gamma != nullptr && r == nullptr))) ||
      (!train && gamma != nullptr && fs == nullptr))
    return (int)cudaErrorInvalidValue;
  const SubW w{(const bf16*)wh, (const bf16*)wl, (const float*)b,
               (const bf16*)oh, (const bf16*)ol, (const float*)bo};
  const Masks mk{(const float*)mask, (const float*)valid, repeat_inc, add_keypad};
  auto f = [](const void* v) { return (const float*)v; };
  return by_width(D, [&](auto tn) {
    constexpr int TN = decltype(tn)::value;
    auto run = passes == 3 ? (train ? forward<TN, 3, 0> : forward<TN, 3, 1>)
                           : (train ? forward<TN, 1, 0> : forward<TN, 1, 1>);
    return run(f(x), f(mem), B, T, n, H, w, f(gamma), f(beta), mk, (float*)y, (float*)qkv,
               (float*)a, (float*)stats, (float*)r, (bf16*)planes, (float*)fs,
               (cudaStream_t)stream);
  });
}

// Gradients of kit_attn_sublayer_tc's training form given dy = dL/dy (B*T,
// D), its inputs and its residuals qkv, a, stats and r (r with a LayerNorm
// only), in mode passes: wih / wil = in_proj_weight (3D, D) and woh / wol =
// out_proj.weight (D, D), the forward's planes in torch's layout (lo null
// with passes 1).  Writes dx, dmem (with a memory), dw_in (3D, D), dw_out
// (D, D), db = [db_in | db_out] (4D) and, with gamma, ln_out = [dgamma |
// dbeta].  scratch: 3 M D + B H T (rounded up to 4) + blocks * 2 D + s_w * 4
// D^2 + s_vec * 4 D + D + M D floats, M = B*T, blocks = ceil(M / 32), s_vec
// = ceil(M / BIAS_ROWS), then (7, or 8 with a memory) M D bf16 a plane; the
// weight gradients sum over s_w row ranges.  D and n as kit_attn_sublayer_tc
// takes them.
extern "C" int kit_attn_sublayer_tc_bwd(int passes, const void* dy, const void* x,
                                        const void* mem, const void* qkv, const void* a,
                                        const void* stats, const void* r, const void* wih,
                                        const void* wil, const void* woh, const void* wol,
                                        const void* gamma, const void* mask, const void* valid,
                                        int B, int T, int D, int n, int H, int repeat_inc,
                                        int add_keypad, int s_w, void* dx, void* dmem,
                                        void* dw_in, void* dw_out, void* db, void* ln_out,
                                        void* scratch, void* stream) {
  const bool lo = passes == 3;
  if (!(passes == 1 || passes == 3) || n > D || H <= 0 || n % H || s_w < 1 ||
      (lo && (wil == nullptr || wol == nullptr)) || (gamma != nullptr && r == nullptr) ||
      (mem != nullptr && dmem == nullptr))
    return (int)cudaErrorInvalidValue;
  const Masks mk{(const float*)mask, (const float*)valid, repeat_inc, add_keypad};
  auto f = [](const void* v) { return (const float*)v; };
  auto h = [](const void* v) { return (const bf16*)v; };
  auto o = [](void* v) { return (float*)v; };
  return by_width(D, [&](auto tn) {
    constexpr int TN = decltype(tn)::value;
    auto run = passes == 3 ? backward<TN, 3> : backward<TN, 1>;
    return run(f(dy), f(x), f(mem), f(qkv), f(a), f(stats), f(r), h(wih), h(wil), h(woh),
               h(wol), f(gamma), mk, B, T, n, H, s_w, o(dx), o(dmem), o(dw_in), o(dw_out), o(db),
               o(ln_out), o(scratch), (cudaStream_t)stream);
  });
}
