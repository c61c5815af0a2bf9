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
// The training forward, redesigned for the H100 where fused_fwd takes (T,
// D, dh) (kernel width 256, 32-wide heads, every key of a video in one
// block: T <= 128; the path above elsewhere): what held it back was the
// five launches and their host work, and q / k / v's planes written to
// device memory only for the core to read them back.  Now two launches
// for self-attention, three with a memory (its k and v first, on
// mode_linear.cuh's kernel with W_in's rows K-major, writing the memory's
// kept planes):
//   1. sub_fwd_kernel, a block per (head slice, video): the head's q / k /
//      v on wgmma from x read in float32 and split in registers (x's kept
//      planes written by the slice's block), then the core on wgmma from
//      the accumulators (see the note above the kernel, sub_fwd.cuh, which
//      the merged serving layers share): a, its planes and the statistics;
//   2. out_ln_kernel: r = x + a W_out^T + bo over whole 64-row tiles, then
//      the LayerNorm in the epilogue: y (and r).
// No scratch: every buffer is an output the backward keeps.
// The backward, redesigned for the H100: what bounded it was launches and
// host work (15 launches and a memset a call), two attention cores that
// each rebuilt s, p and gw, and splits of what the forward had split
// already.  Now 7 launches for self-attention (with its LayerNorm or
// without), 9 for cross-attention (one more product each for dW and dx),
// where the fused core takes (T, dh) (attn_modes.cuh fused_bwd: head widths
// up to 64 and T up to 144 at "high", 240 at "default" for a 32-wide head);
// above that the two-kernel core, its float32 dqkv split and summed as
// before (10 and 12):
//   1. ln_bwd_kernel (dr and its planes, per-block sums of dgamma, dbeta
//      and dr), or without a LayerNorm dy_planes_kernel (dy's planes and
//      column sums);
//   2. dA's planes = dr Wo^T (tc_gemm_kernel, no bias);
//   3. attn_mode_bwd_kernel, one block per (video, head): dq, dk and dv as
//      the planes of [dq | dk | dv] (M, 3D), each video's column sums of
//      them beside (the bias gradients' part);
//   4. [dW_in | dW_out] = [dqkv^T [x | m] | dr^T a] (tc_gemm_kernel, both
//      operands MN-major as they lie), over s_w row ranges, with the
//      planes of x (and the memory) and of a the training forward kept
//      (its keep, which the call must give: no split here);
//   5. sum_jobs_kernel: every ordered sum in one launch (dW_in's and
//      dW_out's row ranges, db_in's videos, db_out's and the LayerNorm's
//      32-row blocks);
//   6. dx = dr + dqkv W_in (EPI_ADD; cross-attention: dr + dq Wq and dmem =
//      [dk dv] W_kv).
// No sum uses atomics: the gradients have the same bits from run to run.
#include "attn_modes.cuh"
#include "common.cuh"
#include "grad.cuh"
#include "mma_bf16.cuh"
#include "mode_linear.cuh"
#include "sgemm_grad.cuh"
#include "sub_fwd.cuh"
#include "tc_gemm.cuh"

using namespace kit;

// (A kernel in namespace kit: nvcc's registration stub cannot tell this
// file's anonymous namespace from kit's, which attn_modes.cuh opens.)
namespace kit {

// The column sums of X (M, ncols; row stride ld) per BIAS_ROWS rows:
// part[z * ncols + c] = the sum over rows [z BIAS_ROWS, (z + 1) BIAS_ROWS)
// of column c; blockIdx.x a tile of 128 columns, 4 a lane (16-byte loads),
// the 8 warps over the range's rows, then added in order of the warps (the
// two-kernel core's dqkv: the bias gradients' part).
constexpr int BIAS_ROWS = 128;

__global__ void __launch_bounds__(NT) bias_grad_kernel(const float* __restrict__ X, int ld, int M,
                                                       int ncols, float* __restrict__ part) {
  __shared__ float4 red[NT / 32][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = 128 * blockIdx.x + 4 * lane, r1 = min(M, (int)(blockIdx.y + 1) * BIAS_ROWS);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = blockIdx.y * BIAS_ROWS + warp; r < r1; r += NT / 32) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(X + (size_t)r * ld + c));
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
  *reinterpret_cast<float4*>(part + (size_t)blockIdx.y * ncols + c) = t;
}

// dr = dy without a LayerNorm: its planes and the block's column sums
// (part + blockIdx.x * D), BM rows a block.
template <int TN>
__global__ void __launch_bounds__(NT) dy_planes_kernel(const float* __restrict__ dy, int M,
                                                       float* __restrict__ part,
                                                       bf16* __restrict__ hi,
                                                       bf16* __restrict__ lo) {
  constexpr int D = 32 * TN;
  __shared__ float red[8 * D];
  float v[TM][TN];
  load_rows<TN>(v, dy, D, blockIdx.x * BM, M);
  block_colsum<TN>(v, red, part + (size_t)blockIdx.x * D, D);
  store_planes<TN>(hi, lo, blockIdx.x * BM, M, v);
}

// Several ordered sums in one launch: job k is sum_split's out[i] = sum
// over z < S of part[z * stride + i], i < n, in its `blocks` blocks.
constexpr int SUM_JOBS = 5;
struct SumJob {
  const float* part;
  int S;
  size_t stride;
  int n;
  float* out;
  int blocks;
};
struct SumJobs {
  SumJob j[SUM_JOBS];
  int count;
};

__global__ void __launch_bounds__(NT) sum_jobs_kernel(const SumJobs jobs) {
  int b = blockIdx.x, k = 0;
  while (k + 1 < jobs.count && b >= jobs.j[k].blocks) b -= jobs.j[k++].blocks;
  const SumJob& jb = jobs.j[k];
  sum_split_block(jb.part, jb.S, jb.stride, jb.n, jb.out, b);
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

// The training forward at FWD_D where fused_fwd takes it: self-attention in
// two launches (sub_fwd_kernel, out_ln_kernel), cross-attention in three
// (the memory's k and v on mode_linear_kernel first); keep receives the
// planes of x, the memory and a; no scratch.
template <int PASSES>
int forward_fused(const float* x, const float* mem, int B, int T, int n, int H, const SubW& w,
                  const float* gamma, const float* beta, const Masks& mk, float* y, float* qkv,
                  float* a32, float* stats, float* r, bf16* keep, cudaStream_t st) {
  constexpr int D = FWD_D;
  const int M = B * T;
  const size_t MD = (size_t)M * D;
  const bool self = mem == nullptr;
  bf16* at = keep;
  const Planes xp = carve<PASSES>(at, MD), mp = self ? xp : carve<PASSES>(at, MD),
               ap = carve<PASSES>(at, MD);
  const bf16* wl = PASSES == 3 ? w.wl : nullptr;
  const bf16* ol = PASSES == 3 ? w.ol : nullptr;
  int rc;
  if (!self) {  // k and v of the memory, in float32 into qkv, and its planes
    CUtensorMap wm[2];
    if ((rc = kmajor_map(&wm[0], w.wh + (size_t)D * D, 2 * D, D)) ||
        (rc = kmajor_map(&wm[1], wl == nullptr ? nullptr : wl + (size_t)D * D, 2 * D, D)))
      return rc;
    const LinArgs la{M, 2 * D, D, D, w.b + D, qkv + D, 3 * D, mp.hi, mp.lo, nullptr};
    KIT_CHECK((linear_launch<PASSES, 0>(mem, D, wm, la, st)));
  }
  SubFwdMaps fm;
  KIT_CHECK(sub_fwd_maps(&fm, x, M, w.wh, wl));
  const SubFwdArgs fa{w.b, qkv, xp.hi, xp.lo, ap.hi, ap.lo, a32, stats, mk.mask, mk.valid,
                      mk.repeat_inc, mk.add_keypad, T, H,
                      (float)(1.4426950408889634 / sqrt((double)(n / H)))};
  KIT_CHECK(self ? (launch_sub_fwd<PASSES, false, true>(fm, fa, B, st))
                 : (launch_sub_fwd<PASSES, true, true>(fm, fa, B, st)));
  return launch_out_ln<PASSES>(ap.hi, ap.lo, w.oh, ol, OutLnArgs{M, n, x, w.bo, gamma, beta, y, r},
                               st);
}

// The forward (see the note at the top).  planes: serving, (5 or, with a
// memory, 6) M D bf16 a plane (x, the memory, the attention output, q / k /
// v); training, q / k / v's (3 M D), and keep those of x, the memory and a
// (the backward's operands); fs: M D floats (r) when serving with a
// LayerNorm.  In training qkv (M, 3D), a32 (M, D) and stats receive the
// residuals, r (M, D) the pre-LN sum with a LayerNorm.
template <int TN, int PASSES, int TB>
int forward(const float* x, const float* mem, int B, int T, int n, int H, const SubW& w,
            const float* gamma, const float* beta, const Masks& mk, float* y, float* qkv,
            float* a32, float* stats, float* r, bf16* planes, bf16* keep, float* fs,
            cudaStream_t st) {
  constexpr int D = 32 * TN;
  constexpr bool TRAIN = TB == 0;
  const int M = B * T, dh = n / H;
  if (TRAIN && fused_fwd(T, D, dh))
    return forward_fused<PASSES>(x, mem, B, T, n, H, w, gamma, beta, mk, y, qkv, a32, stats, r,
                                 keep, st);
  const size_t MD = (size_t)M * D;
  const bool self = mem == nullptr;
  // the planes of x, the memory and a (in training in keep: the backward's
  // operands), then q / k / v's
  bf16* at = TRAIN ? keep : planes;
  const Planes xp = carve<PASSES>(at, MD), mp = self ? xp : carve<PASSES>(at, MD),
               ap = carve<PASSES>(at, MD);
  bf16* cur = TRAIN ? planes : at;
  const Planes qkvp = carve<PASSES>(cur, 3 * MD);
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

// Whether the backward runs the fused core (attn_modes.cuh fused_bwd).
bool fused_core(int passes, int T, int dh) { return fused_bwd(passes == 3 ? 2 : 1, T, dh); }

// The backward (see the note at the top); scratch as
// kit_attn_sublayer_tc_bwd lays it out; acts: the forward's planes of x,
// the memory and a; dmem null means self-attention.
template <int TN, int PASSES>
int backward(const float* dy, const float* qkv, const float* a, const float* stats,
             const float* r, const bf16* wih, const bf16* wil, const bf16* woh, const bf16* wol,
             const float* gamma, const Masks& mk, int B, int T, int n, int H, int s_w,
             const bf16* acts, float* dx, float* dmem, float* dw_in, float* dw_out, float* db,
             float* ln_out, float* scratch, cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int M = B * T, dh = n / H, blocks = (M + BM - 1) / BM,
            s_vec = (M + BIAS_ROWS - 1) / BIAS_ROWS;
  const size_t MD = (size_t)M * D, DD = (size_t)D * D;
  const bool self = dmem == nullptr, fused = fused_core(PASSES, T, dh);
  float* cf = scratch;
  auto take = [&](size_t n) {
    float* p = cf;
    cf += n;
    return p;
  };
  // the two kernels' float32 dq, dk, dv and delta; each block's sums of
  // [dgamma | dbeta] and of dr; [dW_in | dW_out] per row range; [dq | dk |
  // dv]'s column sums per video (fused) or per BIAS_ROWS rows; dr
  float* dqkv = fused ? nullptr : take(3 * MD);                   // M x 3D (two kernels)
  float* delta = fused ? nullptr : take(round_up(B * H * T, 4));  // B x H x T (two kernels)
  float* p_ln = take((size_t)blocks * 2 * D);                     // blocks x 2D
  float* p_dr = take((size_t)blocks * D);                         // blocks x D
  float* p_w = take((size_t)s_w * 4 * DD);                        // s_w x 4 D^2
  float* p_vec = take((size_t)(fused ? B : s_vec) * 3 * D);       // (B or s_vec) x 3D
  float* dr_buf = take(MD);                                       // M x D
  bf16* cur = reinterpret_cast<bf16*>(cf);
  const Planes drp = carve<PASSES>(cur, MD), dap = carve<PASSES>(cur, MD),
               dqp = carve<PASSES>(cur, 3 * MD);
  bf16* kept = const_cast<bf16*>(acts);
  const Planes xp = carve<PASSES>(kept, MD), mp = self ? xp : carve<PASSES>(kept, MD),
               ap = carve<PASSES>(kept, MD);
  int rc;
  // 1. dr: the LayerNorm's backward, or dy; its planes and column sums
  const float* dr = dy;
  if (gamma != nullptr) {
    ln_bwd_kernel<TN><<<blocks, NT, 0, st>>>(dy, r, gamma, M, n, dr_buf, p_ln, drp.hi, drp.lo,
                                             p_dr);
    dr = dr_buf;
  } else {
    dy_planes_kernel<TN><<<blocks, NT, 0, st>>>(dy, M, p_dr, drp.hi, drp.lo);
  }
  KIT_CHECK((int)cudaGetLastError());
  // 2. dA = dr W_out (torch's layout: rows o, columns i), as planes
  KIT_CHECK((project<PASSES, EPI_PLANES, 1>(drp.hi, drp.lo, M, D, woh, wol, D, D,
                                            planes_out(dap, nullptr), st)));
  // 3. the core's gradients as [dq | dk | dv] planes and their column sums;
  // a narrower model (n < D) leaves each part's columns from n on
  // unwritten, and the products below read them: zero them first
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
  c.ldg = 3 * D;
  c.T = T;
  c.dh = dh;
  c.D = D;
  if (fused) {
    if (n < D)
      KIT_CHECK((int)cudaMemsetAsync(dqp.hi, 0, (PASSES == 3 ? 2 : 1) * 3 * MD * sizeof(bf16), st));
    c.gh = dqp.hi;
    c.gl = dqp.lo;
    c.colsum = p_vec;
    KIT_CHECK(attend_bwd_fused<PASSES>(c, B, H, st));
  } else {
    if (n < D) KIT_CHECK((int)cudaMemsetAsync(dqkv, 0, 3 * MD * sizeof(float), st));
    c.dq = dqkv;
    c.dk = dqkv + D;
    c.dv = dqkv + 2 * D;
    c.delta = delta;
    KIT_CHECK(attend_bwd<PASSES>(c, B, H, st));
    KIT_CHECK(split_planes(dqkv, 3 * MD, dqp.hi, dqp.lo, st));
    bias_grad_kernel<<<dim3(3 * D / 128, s_vec), NT, 0, st>>>(dqkv, 3 * D, M, 3 * D, p_vec);
    KIT_CHECK((int)cudaGetLastError());
  }
  // 4. [dW_in | dW_out] per row range: dW_in[j, i] = sum_r dqkv[r, j] [x | m][r,
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
  // 5. every ordered sum in one launch: dW_in, dW_out, db_in, db_out and
  // the LayerNorm's [dgamma | dbeta]
  SumJobs jobs{};
  auto job = [&](const float* part, int S, size_t stride, int cnt, float* out) {
    jobs.j[jobs.count++] = SumJob{part, S, stride, cnt, out, (cnt / 4 + 31) / 32};
  };
  job(p_w, s_w, split, 3 * D * D, dw_in);
  job(p_w + 3 * DD, s_w, split, D * D, dw_out);
  job(p_vec, fused ? B : s_vec, 3 * D, 3 * D, db);
  job(p_dr, blocks, D, D, db + 3 * D);
  if (gamma != nullptr) job(p_ln, blocks, 2 * D, 2 * D, ln_out);
  int nb = 0;
  for (int k = 0; k < jobs.count; ++k) nb += jobs.j[k].blocks;
  sum_jobs_kernel<<<nb, NT, 0, st>>>(jobs);
  KIT_CHECK((int)cudaGetLastError());
  // 6. dx = dr + dqkv W_in (self: K = 3D), or dr + dq W_q and dmem = [dk dv] W_kv
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
// passes 3: two planes), the planes of x, the memory and a first, then q /
// k / v's; in training keep holds the first (2 or 3 B T D a plane: what
// kit_attn_sublayer_tc_bwd takes as acts) and planes only q / k / v's (3 B
// T D a plane); fs: B T D floats (serving with a LayerNorm; else unused).  D is 128, 256, 384 or 512; n <= D the model's true width (the
// operands zero-padded; see common.cuh).
extern "C" int kit_attn_sublayer_tc(int passes, int train, const void* x, const void* mem, int B,
                                    int T, int D, int n, int H, const void* wh, const void* wl,
                                    const void* b, const void* oh, const void* ol, const void* bo,
                                    const void* gamma, const void* beta, const void* mask,
                                    const void* valid, int repeat_inc, int add_keypad, void* y,
                                    void* qkv, void* a, void* stats, void* r, void* planes,
                                    void* keep, void* fs, void* stream) {
  const bool lo = passes == 3;
  if (!(passes == 1 || passes == 3) || n > D || H <= 0 || n % H ||
      (lo && (wl == nullptr || ol == nullptr)) ||
      (train && (qkv == nullptr || a == nullptr || stats == nullptr || keep == nullptr ||
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
               (float*)a, (float*)stats, (float*)r, (bf16*)planes, (bf16*)keep, (float*)fs,
               (cudaStream_t)stream);
  });
}

// Gradients of kit_attn_sublayer_tc's training form given dy = dL/dy (B*T,
// D) and its residuals qkv, a, stats and r (r with a LayerNorm only), in
// mode passes: wih / wil = in_proj_weight (3D, D) and woh / wol =
// out_proj.weight (D, D), the forward's planes in torch's layout (lo null
// with passes 1); acts: the training forward's keep (the planes of x, the
// memory and a).  Writes dx, dmem (with a memory: dmem null means
// self-attention), dw_in (3D, D), dw_out (D, D), db = [db_in | db_out] (4D)
// and, with gamma, ln_out = [dgamma | dbeta].  scratch, M = B*T, blocks =
// ceil(M / 32), s_vec = ceil(M / BIAS_ROWS), floats: where the fused core
// does not take (T, dh) (kit_attn_bwd_fused) 3 M D + B H T (rounded up to
// 4); then blocks * 3 D + s_w * 4 D^2 + (fused ? B : s_vec) * 3 D + M D;
// then 5 M D bf16 a plane; the weight gradients sum over s_w row ranges.  D
// and n as kit_attn_sublayer_tc takes them.
extern "C" int kit_attn_sublayer_tc_bwd(int passes, const void* dy, const void* qkv,
                                        const void* a, const void* stats, const void* r,
                                        const void* wih, const void* wil, const void* woh,
                                        const void* wol, const void* gamma, const void* mask,
                                        const void* valid,
                                        int B, int T, int D, int n, int H, int repeat_inc,
                                        int add_keypad, int s_w, const void* acts, void* dx,
                                        void* dmem, void* dw_in, void* dw_out, void* db,
                                        void* ln_out, void* scratch, void* stream) {
  const bool lo = passes == 3;
  if (!(passes == 1 || passes == 3) || n > D || H <= 0 || n % H || s_w < 1 ||
      (lo && (wil == nullptr || wol == nullptr)) || (gamma != nullptr && r == nullptr) ||
      acts == nullptr)
    return (int)cudaErrorInvalidValue;
  const Masks mk{(const float*)mask, (const float*)valid, repeat_inc, add_keypad};
  auto f = [](const void* v) { return (const float*)v; };
  auto h = [](const void* v) { return (const bf16*)v; };
  auto o = [](void* v) { return (float*)v; };
  return by_width(D, [&](auto tn) {
    constexpr int TN = decltype(tn)::value;
    auto run = passes == 3 ? backward<TN, 3> : backward<TN, 1>;
    return run(f(dy), f(qkv), f(a), f(stats), f(r), h(wih), h(wil), h(woh),
               h(wol), f(gamma), mk, B, T, n, H, s_w, h(acts), o(dx), o(dmem), o(dw_in), o(dw_out),
               o(db), o(ln_out), o(scratch), (cudaStream_t)stream);
  });
}

// 1 where kit_attn_sublayer_tc_bwd runs the fused core at (T, dh) in mode
// passes, else 0 (the two-kernel core): the wrapper sizes the scratch by it.
extern "C" int kit_attn_bwd_fused(int passes, int T, int dh) {
  return fused_core(passes, T, dh) ? 1 : 0;
}

// 1 where kit_attn_sublayer_tc's training form takes the two-kernel path at
// (T, D, dh) (fused_fwd: no scratch), else 0 (the five-launch path, its q /
// k / v planes in scratch): the wrapper sizes the scratch by it.
extern "C" int kit_attn_fwd_fused(int passes, int T, int D, int dh) {
  return (passes == 1 || passes == 3) && fused_fwd(T, D, dh) ? 1 : 0;
}
