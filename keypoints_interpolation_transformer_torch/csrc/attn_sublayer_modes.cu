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
//      the accumulators (see the note above the kernel): a, its planes and
//      the statistics;
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

// ---- the training forward where fused_fwd takes (T, D, dh) -------------------
//
// A block per (head slice of 32 columns, video), 384 threads (a producer
// warpgroup for TMA, two consumer warpgroups of 64 rows): the q / k / v
// projection of the head on wgmma, x read in float32 and split in the
// consumers' registers (mode_linear_kernel's register A), then the
// attention core (attn_mode_kernel's arithmetic) on wgmma as well: each
// group's 64 queries against all keys, q's planes straight from the
// projection's accumulators as the register A of the scores (their layout
// is the fragments'), k's and v^T's planes in shared memory, the scores'
// three terms in their own accumulators per 64 keys, every score kept in
// registers (no second sweep to rebuild them), and p from them as the
// register A of p v_hi and p v_lo.  q, k and v never reach device memory
// as planes.  The block also writes its slice of x's kept planes, and a's
// planes, a in float32 and the statistics of its head.  Head slices past
// the model's heads (n < D) run on the zero-padded weights: q = k = v = 0,
// a = 0, no statistics.  Cross-attention projects only q here (its k and v
// come from the memory's projection, a launch before, in float32).
constexpr int FWD_D = 256, FWD_DH = 32, FWD_T = 128;  // what fused_fwd takes

template <int PASSES, bool CROSS>
struct SubFwd {
  static constexpr int PL = PASSES == 3 ? 2 : 1;
  static constexpr int NW = CROSS ? FWD_DH : 3 * FWD_DH;  // the head's projected columns
  static constexpr int XBOX = 128 * 32 * 4;
  static constexpr int WT = NW * 128;  // one plane of the head's weight rows, 64 deep
  static constexpr int STAGE = 2 * XBOX + PL * WT;
  static constexpr int STEPS = FWD_D / 64;
  static constexpr int STAGES = cmin(STEPS, TC_SMEM / STAGE);
  static constexpr int CORE = 2 * PL * 128 * FWD_DH * 2 + 128 * 8;  // k, v^T planes, key bias
  static constexpr int SMEM = cmax(STAGES * STAGE, CORE) + 1024;
  static_assert(STAGES >= 2, "a ring of at least two stages");
};

struct SubFwdMaps {
  CUtensorMap x;     // x (M, D) float32, 32 x 128 boxes
  CUtensorMap w[2];  // W_in's planes (3D, D), 64 x 32 boxes (K-major)
};

struct SubFwdArgs {
  const float* b;      // (3D): [bq | bk | bv]
  float* qkv;          // (M, 3D) float32; in cross-attention k and v read from it
  bf16 *xh, *xl;       // x's kept planes (M, D)
  bf16 *ah, *al;       // a's kept planes (M, D)
  float* a32;          // (M, D)
  float* stats;        // (B, H, T, 2)
  const float *mask, *valid;
  int repeat_inc, add_keypad;
  int T, H;
  float qs;            // log2(e) / sqrt(dh)
};

// The core's operands in shared memory, bf16 planes in wgmma's canonical
// K-major layout without swizzle: core matrices of 8 rows x 16 bytes (8
// values), CORE_LBO = 128 bytes apart along the contraction and `sbo`
// apart along the rows.  k: 128 keys x 32 columns of the head (the scores
// contract over the head's columns), v^T: 32 columns x 128 keys (p v
// contracts over the keys); KT_BYTES a plane of either.
constexpr int CORE_LBO = 128, K_SBO = 4 * CORE_LBO, V_SBO = 16 * CORE_LBO;
constexpr int KT_BYTES = 128 * FWD_DH * 2;

// The byte offset of element (row n, contraction k) in that layout.
__device__ __forceinline__ int core_off(int n, int k, int sbo) {
  return (n >> 3) * sbo + (k >> 3) * CORE_LBO + (n & 7) * 16 + (k & 7) * 2;
}

// A shared-memory matrix descriptor of that layout (no swizzle).
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t sbo) {
  return desc_encode(addr) | (desc_encode(CORE_LBO) << 16) | (desc_encode(sbo) << 32);
}

// Cross-attention: k and v of the head's 32 columns, rows [0, 128) of the
// video from the memory's float32 projection in qkv (row stride 3 FWD_D),
// split into the planes of k and of v^T, zero from row T: by the 256
// consumer threads, 8 columns a thread.
template <int PL>
__device__ __forceinline__ void stage_kv(bf16* Kp, bf16* Vp, const float* qkv, size_t vid, int hc,
                                         int T) {
  constexpr int D = FWD_D;
  for (int i = threadIdx.x; i < 2 * 128 * 4; i += 32 * CONSUMER_WARPS) {
    const int isv = i >> 9, r = (i >> 2) & 127, c = 8 * (i & 3);
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.f;
    if (r < T) {
      const float* s = qkv + (vid + r) * 3 * D + (1 + isv) * D + hc + c;
      const float4 a = __ldg(reinterpret_cast<const float4*>(s));
      const float4 b = __ldg(reinterpret_cast<const float4*>(s + 4));
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z,
      v[7] = b.w;
    }
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split2(v[2 * e], v[2 * e + 1], h[e], l[e]);
    if (!isv) {  // 8 columns of key r: one 16-byte row of a core matrix
      bf16* at = Kp + core_off(r, c, K_SBO) / 2;
      *reinterpret_cast<uint4*>(at) = make_uint4(h[0], h[1], h[2], h[3]);
      if (PL == 2) *reinterpret_cast<uint4*>(at + KT_BYTES / 2) = make_uint4(l[0], l[1], l[2], l[3]);
    } else {  // column r of rows c .. c + 7 of v^T
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        bf16* at = Vp + core_off(c + e, r, V_SBO) / 2;
        *reinterpret_cast<uint16_t*>(at) = (uint16_t)(h[e >> 1] >> (16 * (e & 1)));
        if (PL == 2)
          *reinterpret_cast<uint16_t*>(at + KT_BYTES / 2) = (uint16_t)(l[e >> 1] >> (16 * (e & 1)));
      }
    }
  }
}

template <int PASSES, bool CROSS>
__global__ void __launch_bounds__(WG_THREADS, 1)
    sub_fwd_kernel(const __grid_constant__ SubFwdMaps mp, const SubFwdArgs p) {
  using G = SubFwd<PASSES, CROSS>;
  constexpr int PL = G::PL, STAGES = G::STAGES, NW = G::NW, NA = NW / 2;
  constexpr int D = FWD_D;
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int warp = warp_index(), lane = threadIdx.x & 31;
  const int hs = blockIdx.x, T = p.T;  // the head slice, its columns hc ..
  const int hc = FWD_DH * hs;
  const size_t vid = (size_t)blockIdx.y * T;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int role = warpgroup_index();
  if (role == 2) {  // the producer: x's 128 rows and the head's weight rows
    reg_dealloc<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      RingPos at;
      for (int kt = 0; kt < G::STEPS; ++kt) {
        const int k0 = 64 * kt;
        mbar_wait(&empty[at.stage], at.phase ^ 1);
        unsigned char* sb = ring + at.stage * G::STAGE;
        uint64_t* bar = &full[at.stage];
        mbar_expect_tx(bar, G::STAGE);
        tma_load(sb, &mp.x, k0, (int)vid, bar);
        tma_load(sb + G::XBOX, &mp.x, k0 + 32, (int)vid, bar);
        for (int pl = 0; pl < PL; ++pl) {
          unsigned char* sw = sb + 2 * G::XBOX + pl * G::WT;
          tma_load(sw, &mp.w[pl], k0, hc, bar);  // q's rows
          if (!CROSS) {
            tma_load(sw + 32 * 128, &mp.w[pl], k0, D + hc, bar);      // k's
            tma_load(sw + 64 * 128, &mp.w[pl], k0, 2 * D + hc, bar);  // v's
          }
        }
        at.advance<STAGES>();
      }
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  const int wg = role, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * wq + g;  // the thread's rows: r0 and r0 + 8
  // key threadIdx.x's bias, its loads in flight during the projection
  const float2 key_b = threadIdx.x < 128
                           ? key_bias(p.mask == nullptr ? nullptr : p.mask + vid,
                                      p.valid == nullptr ? nullptr : p.valid + vid,
                                      threadIdx.x, T, p.repeat_inc, p.add_keypad)
                           : make_float2(0.f, 0.f);
  float acc[NA], acc1[NA];
#pragma unroll
  for (int e = 0; e < NA; ++e) acc[e] = acc1[e] = 0.f;
  uint32_t fh0[4][4], fl0[4][4], fh1[4][4], fl1[4][4];
  RingPos at;
  int prev = -1, kt = 0;
  auto stage = [&](float(&d)[NA], uint32_t(&fh)[4][4], uint32_t(&fl)[4][4]) {
    mbar_wait(&full[at.stage], at.phase);
    const unsigned char* sb = ring + at.stage * G::STAGE;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const unsigned char* box = sb + (s >> 1) * G::XBOX;
      const int c = 16 * (s & 1) + 2 * t;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 v = box_pair(box, r0 + 8 * (h & 1), c + 8 * (h >> 1));
        split2(v.x, v.y, fh[s][h], fl[s][h]);
      }
      // the block's 32 columns of x's kept planes: steps 2 (hs % 2) and
      // the next of stage hs / 2, the video's rows
      if (2 * kt + (s >> 1) == hs) {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int m = r0 + 8 * (h & 1);
          if (m >= T) continue;
          const size_t o = (vid + m) * D + 64 * kt + 16 * s + 2 * t + 8 * (h >> 1);
          *reinterpret_cast<uint32_t*>(p.xh + o) = fh[s][h];
          if (PASSES == 3) *reinterpret_cast<uint32_t*>(p.xl + o) = fl[s][h];
        }
      }
    }
    const uint32_t b0 = smem_u32(sb + 2 * G::XBOX);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t b = b0 + s * 32;
      if constexpr (CROSS) {
        wgmma_rs32<0>(d, fh[s], desc_k(b));
        if (PASSES == 3) {
          wgmma_rs32<0>(d, fh[s], desc_k(b + G::WT));
          wgmma_rs32<0>(d, fl[s], desc_k(b));
        }
      } else {
        wgmma_rs96<0>(d, fh[s], desc_k(b));
        if (PASSES == 3) {
          wgmma_rs96<0>(d, fh[s], desc_k(b + G::WT));
          wgmma_rs96<0>(d, fl[s], desc_k(b));
        }
      }
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = at.stage;
    at.advance<STAGES>();
    ++kt;
  };
  while (kt < G::STEPS) {
    stage(acc, fh0, fl0);
    if (kt < G::STEPS) stage(acc1, fh1, fl1);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  fence_acc(acc1);
#pragma unroll
  for (int e = 0; e < NA; ++e) acc[e] += acc1[e];
  consumers_sync();  // the ring is read: the core's planes take its place

  // q, k and v of the head: + bias, kept in float32; q times qs (rounded
  // once, as the serving form folds it) split into the register A
  // fragments of the scores (the accumulators' layout is the fragments'),
  // k and v split into their planes in shared memory for both groups
  bf16* Kp = reinterpret_cast<bf16*>(ring);  // PL planes of k, KT_BYTES each
  bf16* Vp = Kp + PL * KT_BYTES / 2;          // PL planes of v^T
  float2* kbias = reinterpret_cast<float2*>(Vp + PL * KT_BYTES / 2);
  uint32_t qf[2][2][4];  // [hi, lo][16-deep step][fragment]
#pragma unroll
  for (int jj = 0; jj < NW / 8; ++jj) {
    const int part = jj / 4, c = 8 * (jj & 3) + 2 * t;  // q, k, v; the column in the head
    const float2 b = __ldg(reinterpret_cast<const float2*>(p.b + part * D + hc + c));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;  // the row: a query for q, a key for k and v
      float2 v = make_float2(0.f, 0.f);
      if (r < T) {
        v = make_float2(acc[4 * jj + 2 * h] + b.x, acc[4 * jj + 2 * h + 1] + b.y);
        *reinterpret_cast<float2*>(p.qkv + (vid + r) * 3 * D + part * D + hc + c) = v;
        if (part == 0) v = make_float2(__fmul_rn(v.x, p.qs), __fmul_rn(v.y, p.qs));
      }
      uint32_t hi, lo;
      split2(v.x, v.y, hi, lo);
      if (part == 0) {  // fragment 2 (jj & 1) + h of step jj / 2
        qf[0][jj >> 1][2 * (jj & 1) + h] = hi;
        qf[1][jj >> 1][2 * (jj & 1) + h] = lo;
      } else if (part == 1) {
        bf16* at = Kp + core_off(r, c, K_SBO) / 2;
        *reinterpret_cast<uint32_t*>(at) = hi;
        if (PL == 2) *reinterpret_cast<uint32_t*>(at + KT_BYTES / 2) = lo;
      } else {  // v^T: row c (and c + 1), column r
        bf16* at = Vp + core_off(c, r, V_SBO) / 2;
        bf16* at1 = Vp + core_off(c + 1, r, V_SBO) / 2;
        *reinterpret_cast<uint16_t*>(at) = (uint16_t)(hi & 0xffffu);
        *reinterpret_cast<uint16_t*>(at1) = (uint16_t)(hi >> 16);
        if (PL == 2) {
          *reinterpret_cast<uint16_t*>(at + KT_BYTES / 2) = (uint16_t)(lo & 0xffffu);
          *reinterpret_cast<uint16_t*>(at1 + KT_BYTES / 2) = (uint16_t)(lo >> 16);
        }
      }
    }
  }
  if constexpr (CROSS) {  // k and v from the memory's projection
    stage_kv<PL>(Kp, Vp, p.qkv, vid, hc, T);
  }
  if (threadIdx.x < 128) kbias[threadIdx.x] = key_b;
  fence_proxy_async();  // the planes, written by the threads, read by wgmma
  consumers_sync();
  if (64 * wg >= T) return;  // no query row of the group's 64 in the video

  // the scores of the group's 64 rows against 64 keys at a time (the two
  // halves of T <= 128): the three terms in their own accumulators, added
  // as the TPU kernel adds its three dots, then + the bias (-inf past T,
  // where k's planes hold zeros)
  const int qa = r0, qb = r0 + 8;  // the thread's two query rows
  float sc[2][32];
#pragma unroll
  for (int kh = 0; kh < 2; ++kh) {
    float hh[32], hl[32], lh[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) hh[i] = hl[i] = lh[i] = 0.f;
    const uint32_t kb = smem_u32(Kp) + kh * 8 * K_SBO;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint32_t b = kb + ks * 2 * CORE_LBO;
      wgmma_rs64(hh, qf[0][ks], desc_plain(b, K_SBO));
      if (PASSES == 3) {
        wgmma_rs64(hl, qf[1][ks], desc_plain(b, K_SBO));
        wgmma_rs64(lh, qf[0][ks], desc_plain(b + KT_BYTES, K_SBO));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(hh);
    fence_acc(hl);
    fence_acc(lh);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jj + e, key = 64 * kh + 8 * jj + 2 * t + (e & 1);
        const float2 bk = kbias[key];
        const float dd = PASSES == 3 ? (hh[i] + hl[i]) + lh[i] : hh[i];
        sc[kh][i] = dd + (key > (e < 2 ? qa : qb) ? bk.y : bk.x);
      }
  }
  // each row's max over the lane's keys, then the quad's four lanes (the
  // row's other keys); finite: key 0 < T
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int kh = 0; kh < 2; ++kh)
#pragma unroll
    for (int i = 0; i < 32; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], sc[kh][i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
  }
  // e = exp2(s - m) in place and each row's sum l in key order, then the
  // quad's lanes
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int kh = 0; kh < 2; ++kh)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      sc[kh][i] = exp2f(sc[kh][i] - m[h]);
      l[h] += sc[kh][i];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if (hs < p.H && t == 0) {  // the quad's lanes hold the same (m, l)
    float* st = p.stats + ((size_t)blockIdx.y * p.H + hs) * T * 2;
    if (qa < T) *reinterpret_cast<float2*>(st + 2 * qa) = make_float2(m[0], l[0]);
    if (qb < T) *reinterpret_cast<float2*>(st + 2 * qb) = make_float2(m[1], l[1]);
  }
  // p = e (1 / l), one bf16, as the register A of p v_hi and p v_lo (16
  // keys a step), each into its own accumulator
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  uint32_t pa[8][4];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int i = 4 * (2 * (ks & 3) + (f >> 1)) + 2 * (f & 1), h = f & 1;
      pa[ks][f] = pack_bf16(sc[ks >> 2][i] * inv[h], sc[ks >> 2][i + 1] * inv[h]);
    }
  float oh[16], ol[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) oh[i] = ol[i] = 0.f;
  const uint32_t vb = smem_u32(Vp);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {  // p = 0 past T
    const uint32_t b = vb + ks * 2 * CORE_LBO;
    wgmma_rs32<0>(oh, pa[ks], desc_plain(b, V_SBO));
    if (PASSES == 3) wgmma_rs32<0>(ol, pa[ks], desc_plain(b + KT_BYTES, V_SBO));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(oh);
  fence_acc(ol);
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h == 0 ? qa : qb, c = 8 * jj + 2 * t;
      if (row >= T) continue;
      const int i = 4 * jj + 2 * h;
      const float o0 = PASSES == 3 ? oh[i] + ol[i] : oh[i];
      const float o1 = PASSES == 3 ? oh[i + 1] + ol[i + 1] : oh[i + 1];
      const size_t o_at = (vid + row) * D + hc + c;
      uint32_t hi, lo;
      split2(o0, o1, hi, lo);
      *reinterpret_cast<uint32_t*>(p.ah + o_at) = hi;
      if (PASSES == 3) *reinterpret_cast<uint32_t*>(p.al + o_at) = lo;
      *reinterpret_cast<float2*>(p.a32 + o_at) = make_float2(o0, o1);
    }
}

// r = x + a W_out^T + bo over 64 rows a block and all D = FWD_D columns
// (each consumer warpgroup 128 of them, m64n128 on wgmma from a's kept
// planes and W_out's, both K-major in 32-deep stages, 64-byte swizzled),
// then y = LN(r) over whole rows in the epilogue (ln_fwd_kernel's
// layer_norm): one launch for what was an out-projection and a LayerNorm
// pass.
struct OutLnMaps {
  CUtensorMap a[2];  // a's planes (M, D), 32 x 64 boxes
  CUtensorMap w[2];  // W_out's planes (D, D) in torch's layout, 32 x 128 boxes
};

struct OutLnArgs {
  int M, nw;                  // rows; the LayerNorm's width (the model's n)
  const float *x, *bo, *gamma, *beta;  // gamma null: no LayerNorm
  float *y, *r;               // r (with a LayerNorm) the pre-LN sum
};

template <int PASSES>
struct OutLn {
  static constexpr int PL = PASSES == 3 ? 2 : 1;
  static constexpr int AT = 64 * 64, BT = FWD_D * 64;  // a plane of A's, of B's tile
  static constexpr int STAGE = PL * (AT + BT);
  static constexpr int STEPS = FWD_D / 32;
  static constexpr int STAGES = cmin(STEPS, TC_SMEM / STAGE);
  static constexpr int LDC = FWD_D + 8;
  static constexpr int SMEM = cmax(STAGES * STAGE, 64 * LDC * 4) + 1024;
  static_assert(STAGES >= 2, "a ring of at least two stages");
};

template <int PASSES>
__global__ void __launch_bounds__(WG_THREADS, 1)
    out_ln_kernel(const __grid_constant__ OutLnMaps mp, const OutLnArgs p) {
  using G = OutLn<PASSES>;
  constexpr int STAGES = G::STAGES, PL = G::PL, D = FWD_D, TN = D / 32;
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int warp = warp_index(), lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * 64;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int role = warpgroup_index();
  if (role == 2) {
    reg_dealloc<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      RingPos at;
      for (int kt = 0; kt < G::STEPS; ++kt) {
        const int k0 = 32 * kt;
        mbar_wait(&empty[at.stage], at.phase ^ 1);
        unsigned char* sb = ring + at.stage * G::STAGE;
        uint64_t* bar = &full[at.stage];
        mbar_expect_tx(bar, G::STAGE);
        for (int pl = 0; pl < PL; ++pl) {
          tma_load(sb + pl * G::AT, &mp.a[pl], k0, m0, bar);
          unsigned char* sw = sb + PL * G::AT + pl * G::BT;
          for (int h = 0; h < D / 128; ++h) tma_load(sw + h * 128 * 64, &mp.w[pl], k0, 128 * h, bar);
        }
        at.advance<STAGES>();
      }
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  const int wg = role, wq = warp & 3, g = lane >> 2, t = lane & 3;
  float acc[64], acc1[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = acc1[e] = 0.f;
  RingPos at;
  int prev = -1;
  auto stage = [&](float(&d)[64]) {
    mbar_wait(&full[at.stage], at.phase);
    const uint32_t sb = smem_u32(ring + at.stage * G::STAGE);
    const uint32_t a0 = sb, b0 = sb + PL * G::AT + wg * 128 * 64;  // the group's 128 columns
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint32_t a = a0 + s * 32, b = b0 + s * 32;
      wgmma_ss128<0, 0>(d, desc_k64(a), desc_k64(b));
      if (PASSES == 3) {
        wgmma_ss128<0, 0>(d, desc_k64(a), desc_k64(b + G::BT));
        wgmma_ss128<0, 0>(d, desc_k64(a + G::AT), desc_k64(b));
      }
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = at.stage;
    at.advance<STAGES>();
  };
  for (int kt = 0; kt < G::STEPS; kt += 2) {
    stage(acc);
    if (kt + 1 < G::STEPS) stage(acc1);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  fence_acc(acc1);
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] += acc1[e];
  if (prev >= 0) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);
  }
  consumers_sync();
  float* Cs = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(Cs + (16 * wq + g + 8 * h) * G::LDC + 128 * wg + 8 * jj + 2 * t) =
          make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
  consumers_sync();
  // whole rows: 8 a warp, a lane's columns col_of(j) (4 lane .. + 3, and
  // 128 on), r = x + (product + bo), then the LayerNorm over nw columns
  for (int rr = warp; rr < 64; rr += CONSUMER_WARPS) {
    const int m = m0 + rr;
    if (m >= p.M) break;
    float v[1][TN];
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int c = 128 * q + 4 * lane;
      const float4 cv = *reinterpret_cast<const float4*>(Cs + rr * G::LDC + c);
      const float4 b = __ldg(reinterpret_cast<const float4*>(p.bo + c));
      const float4 xv = __ldg(reinterpret_cast<const float4*>(p.x + (size_t)m * D + c));
      const float4 s = make_float4(xv.x + (cv.x + b.x), xv.y + (cv.y + b.y), xv.z + (cv.z + b.z),
                                   xv.w + (cv.w + b.w));
      v[0][4 * q] = s.x, v[0][4 * q + 1] = s.y, v[0][4 * q + 2] = s.z, v[0][4 * q + 3] = s.w;
      if (p.gamma != nullptr) *reinterpret_cast<float4*>(p.r + (size_t)m * D + c) = s;
    }
    if (p.gamma != nullptr) layer_norm<TN>(v, p.gamma, p.beta, p.nw);
#pragma unroll
    for (int q = 0; q < TN / 4; ++q)
      *reinterpret_cast<float4*>(p.y + (size_t)m * D + 128 * q + 4 * lane) =
          make_float4(v[0][4 * q], v[0][4 * q + 1], v[0][4 * q + 2], v[0][4 * q + 3]);
  }
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

// Whether the training forward takes the two-kernel path (sub_fwd_kernel,
// out_ln_kernel) at (T, D, dh): the kernel width FWD_D, head width FWD_DH,
// every key of a video in one block (T <= FWD_T); else the five-launch one.
bool fused_fwd(int T, int D, int dh) {
  return D == FWD_D && dh == FWD_DH && T >= 1 && T <= FWD_T;
}

template <int PASSES, bool CROSS>
int launch_sub_fwd(const SubFwdMaps& mp, const SubFwdArgs& a, int B, cudaStream_t st) {
  using G = SubFwd<PASSES, CROSS>;
  static bool ready = false;
  cudaError_t e = allow_smem(sub_fwd_kernel<PASSES, CROSS>, G::SMEM, ready);
  if (e != cudaSuccess) return (int)e;
  sub_fwd_kernel<PASSES, CROSS><<<dim3(FWD_D / FWD_DH, B), WG_THREADS, G::SMEM, st>>>(mp, a);
  return (int)cudaGetLastError();
}

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
  if ((rc = x_map(&fm.x, x, M, D, D)) || (rc = plane_map(&fm.w[0], w.wh, 3 * D, D, 32)) ||
      (rc = plane_map(&fm.w[1], wl, 3 * D, D, 32)))
    return rc;
  const SubFwdArgs fa{w.b, qkv, xp.hi, xp.lo, ap.hi, ap.lo, a32, stats, mk.mask, mk.valid,
                      mk.repeat_inc, mk.add_keypad, T, H,
                      (float)(1.4426950408889634 / sqrt((double)(n / H)))};
  KIT_CHECK(self ? (launch_sub_fwd<PASSES, false>(fm, fa, B, st))
                 : (launch_sub_fwd<PASSES, true>(fm, fa, B, st)));
  using O = OutLn<PASSES>;
  static bool ready = false;
  cudaError_t e = allow_smem(out_ln_kernel<PASSES>, O::SMEM, ready);
  if (e != cudaSuccess) return (int)e;
  OutLnMaps om;
  if ((rc = kmajor_map(&om.a[0], ap.hi, M, D, 64)) ||
      (rc = kmajor_map(&om.a[1], PASSES == 3 ? ap.lo : nullptr, M, D, 64)) ||
      (rc = kmajor_map(&om.w[0], w.oh, D, D)) || (rc = kmajor_map(&om.w[1], ol, D, D)))
    return rc;
  const OutLnArgs oa{M, n, x, w.bo, gamma, beta, y, r};
  out_ln_kernel<PASSES><<<(M + 63) / 64, WG_THREADS, O::SMEM, st>>>(om, oa);
  return (int)cudaGetLastError();
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
