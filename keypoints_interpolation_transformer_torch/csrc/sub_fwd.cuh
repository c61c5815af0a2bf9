// The attention sublayer's forward in the precision modes "high" (bf16x3)
// and "default" (one bf16 pass) in two kernels, where fused_fwd takes the
// shape (kernel width 256, 32-wide heads, T <= 128):
//   * sub_fwd_kernel, a block per (head slice, video): the head's q / k / v
//     on wgmma from x read in float32 and split in registers, then the
//     attention core on wgmma from the accumulators: a's planes (serving
//     cross-attention, MEMKV: k / v from the memory, read the same way);
//   * out_ln_kernel: r = x + a W_out^T + bo over 64-row tiles, the
//     LayerNorm (when given) in the epilogue.
// attn_sublayer_modes.cu runs them for the sublayer's training forward
// (KEEP: the residuals the backward reads), layer_modes.cu for the merged
// serving layers' attention halves (nothing kept; q's scale folded into Wq
// and bq before the split, as the merged layers' contract has it).  The
// weights are read K-major: W_in = [Wq | Wk | Wv]^T (3D, D) and W_out =
// Wo^T (D, D), torch's layout (the serving planes are the transposes of
// the folded Flax-layout ones).  See attn_sublayer_modes.cu's note for the
// design.
#pragma once

#include "attn_modes.cuh"
#include "common.cuh"
#include "mma_bf16.cuh"
#include "mode_linear.cuh"
#include "tc_gemm.cuh"

// (Kernels in namespace kit: nvcc's registration stub cannot tell a file's
// anonymous namespace from kit's, which attn_modes.cuh opens.)
namespace kit {

// ---- sub_fwd_kernel ------------------------------------------------------------
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
// as planes.  The block writes a's planes; in training (KEEP) also its
// slice of x's kept planes, q / k / v and a in float32 and the statistics
// of its head, and q is scaled after its bias (the serving form reads Wq
// and bq with the scale folded in, and keeps nothing but a's planes).
// Head slices past the model's heads (n < D) run on the zero-padded
// weights: q = k = v = 0, a = 0, no statistics.  Training cross-attention
// projects only q here (its k and v come from the memory's projection, a
// launch before, in float32: the backward keeps them); serving
// cross-attention (MEMKV) projects k and v from the memory in the block
// too, first, in four more 64-deep steps of the ring: the memory is read
// once a head slice, in place of a launch that writes its float32 k / v
// to device memory and a stage that reads them back.
constexpr int FWD_D = 256, FWD_DH = 32, FWD_T = 128;  // what fused_fwd takes

// Whether the two-kernel forward (sub_fwd_kernel, out_ln_kernel) takes (T,
// D, dh): the kernel width FWD_D, head width FWD_DH, every key of a video
// in one block (T <= FWD_T).  The training sublayer
// (attn_sublayer_modes.cu) and the merged serving layers (layer_modes.cu)
// in a mode take it there, their longer launch chains elsewhere.
inline bool fused_fwd(int T, int D, int dh) {
  return D == FWD_D && dh == FWD_DH && T >= 1 && T <= FWD_T;
}

template <int PASSES, bool CROSS, bool MEMKV = false>
struct SubFwd {
  static constexpr int PL = PASSES == 3 ? 2 : 1;
  static constexpr int NW = CROSS && !MEMKV ? FWD_DH : 3 * FWD_DH;  // the head's projected columns
  static constexpr int XBOX = 128 * 32 * 4;
  static constexpr int WT = (MEMKV ? 2 * FWD_DH : NW) * 128;  // one plane of a stage's weight rows
  static constexpr int STAGE = 2 * XBOX + PL * WT;
  static constexpr int STEPS = (MEMKV ? 2 : 1) * FWD_D / 64;
  static constexpr int STAGES = cmin(STEPS, TC_SMEM / STAGE);
  static constexpr int CORE = 2 * PL * 128 * FWD_DH * 2 + 128 * 8;  // k, v^T planes, key bias
  static constexpr int SMEM = cmax(STAGES * STAGE, CORE) + 1024;
  static_assert(STAGES >= 2, "a ring of at least two stages");
};

struct SubFwdMaps {
  CUtensorMap x;     // x (M, D) float32, 32 x 128 boxes
  CUtensorMap w[2];  // W_in's planes (3D, D), 64 x 32 boxes (K-major)
  CUtensorMap m;     // MEMKV: the memory (M, D) float32, as x
};

struct SubFwdArgs {
  const float* b;      // (3D): [bq | bk | bv] (serving: [bq s | bk | bv])
  float* qkv;          // KEEP: (M, 3D) float32
  bf16 *xh, *xl;       // KEEP: x's kept planes (M, D)
  bf16 *ah, *al;       // a's planes (M, D)
  float* a32;          // KEEP: (M, D)
  float* stats;        // KEEP: (B, H, T, 2)
  const float *mask, *valid;
  int repeat_inc, add_keypad;
  int T, H;
  float qs;            // KEEP: log2(e) / sqrt(dh)
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

template <int PASSES, bool CROSS, bool KEEP, bool MEMKV = false>
__global__ void __launch_bounds__(WG_THREADS, 1)
    sub_fwd_kernel(const __grid_constant__ SubFwdMaps mp, const SubFwdArgs p) {
  using G = SubFwd<PASSES, CROSS, MEMKV>;
  static_assert(!MEMKV || (CROSS && !KEEP), "k / v projected in the block: serving only");
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
        // MEMKV: steps 0 .. 3 the memory against k's and v's rows, then x
        // against q's
        const bool kvs = MEMKV && kt < FWD_D / 64;
        const int k0 = 64 * (kt % (FWD_D / 64));
        const CUtensorMap* xm = kvs ? &mp.m : &mp.x;
        mbar_wait(&empty[at.stage], at.phase ^ 1);
        unsigned char* sb = ring + at.stage * G::STAGE;
        uint64_t* bar = &full[at.stage];
        mbar_expect_tx(bar, MEMKV ? 2 * G::XBOX + PL * (kvs ? 64 : 32) * 128 : G::STAGE);
        tma_load(sb, xm, k0, (int)vid, bar);
        tma_load(sb + G::XBOX, xm, k0 + 32, (int)vid, bar);
        for (int pl = 0; pl < PL; ++pl) {
          unsigned char* sw = sb + 2 * G::XBOX + pl * G::WT;
          if (kvs) {
            tma_load(sw, &mp.w[pl], k0, D + hc, bar);                 // k's
            tma_load(sw + 32 * 128, &mp.w[pl], k0, 2 * D + hc, bar);  // v's
            continue;
          }
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
  auto stage = [&](bool kvs, float(&d)[NA], uint32_t(&fh)[4][4], uint32_t(&fl)[4][4]) {
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
      if (KEEP && 2 * kt + (s >> 1) == hs) {
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
      if constexpr (MEMKV) {
        float(&dkv)[32] = *reinterpret_cast<float(*)[32]>(d + 16);  // k, v: columns 32 .. 95
        float(&dq)[16] = *reinterpret_cast<float(*)[16]>(d);        // q: columns 0 .. 31
        if (kvs) {
          wgmma_rs64(dkv, fh[s], desc_k(b));
          if (PASSES == 3) {
            wgmma_rs64(dkv, fh[s], desc_k(b + G::WT));
            wgmma_rs64(dkv, fl[s], desc_k(b));
          }
        } else {
          wgmma_rs32<0>(dq, fh[s], desc_k(b));
          if (PASSES == 3) {
            wgmma_rs32<0>(dq, fh[s], desc_k(b + G::WT));
            wgmma_rs32<0>(dq, fl[s], desc_k(b));
          }
        }
      } else if constexpr (CROSS) {
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
  if constexpr (MEMKV) {
    constexpr bool kv_t = true, q_t = false;
#pragma unroll 1
    for (int i = 0; i < FWD_D / 128; ++i) {
      stage(kv_t, acc, fh0, fl0);
      stage(kv_t, acc1, fh1, fl1);
    }
#pragma unroll 1
    for (int i = 0; i < FWD_D / 128; ++i) {
      stage(q_t, acc, fh0, fl0);
      stage(q_t, acc1, fh1, fl1);
    }
  } else {
    constexpr bool one = false;
    while (kt < G::STEPS) {
      stage(one, acc, fh0, fl0);
      if (kt < G::STEPS) stage(one, acc1, fh1, fl1);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  fence_acc(acc1);
#pragma unroll
  for (int e = 0; e < NA; ++e) acc[e] += acc1[e];
  consumers_sync();  // the ring is read: the core's planes take its place

  // q, k and v of the head: + bias (in training kept in float32, and q
  // times qs, rounded once, as the serving form folds it), q split into
  // the register A fragments of the scores (the accumulators' layout is
  // the fragments'), k and v into their planes in shared memory for both
  // groups
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
        if (KEEP) {
          *reinterpret_cast<float2*>(p.qkv + (vid + r) * 3 * D + part * D + hc + c) = v;
          if (part == 0) v = make_float2(__fmul_rn(v.x, p.qs), __fmul_rn(v.y, p.qs));
        }
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
  if constexpr (CROSS && !MEMKV) {  // k and v from the memory's projection
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
  if (KEEP && hs < p.H && t == 0) {  // the quad's lanes hold the same (m, l)
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
      if (KEEP) *reinterpret_cast<float2*>(p.a32 + o_at) = make_float2(o0, o1);
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
  float *y, *r;               // r, null or (with a LayerNorm) the pre-LN sum
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
      if (p.r != nullptr) *reinterpret_cast<float4*>(p.r + (size_t)m * D + c) = s;
    }
    if (p.gamma != nullptr) layer_norm<TN>(v, p.gamma, p.beta, p.nw);
#pragma unroll
    for (int q = 0; q < TN / 4; ++q)
      *reinterpret_cast<float4*>(p.y + (size_t)m * D + 128 * q + 4 * lane) =
          make_float4(v[0][4 * q], v[0][4 * q + 1], v[0][4 * q + 2], v[0][4 * q + 3]);
  }
}

// sub_fwd_kernel's maps: x (M, FWD_D) float32, W_in's planes wh / wl
// (3 FWD_D, FWD_D) K-major (wl null at "default"); the memory's left zero.
inline int sub_fwd_maps(SubFwdMaps* m, const float* x, int M, const bf16* wh, const bf16* wl) {
  constexpr int D = FWD_D;
  *m = SubFwdMaps{};
  int rc;
  if ((rc = x_map(&m->x, x, M, D, D)) || (rc = plane_map(&m->w[0], wh, 3 * D, D, 32)) ||
      (rc = plane_map(&m->w[1], wl, 3 * D, D, 32)))
    return rc;
  return 0;
}

// One launch of sub_fwd_kernel: a block per (head slice, video).
// Internal linkage: see sgemm_grad.cuh's host side.
template <int PASSES, bool CROSS, bool KEEP, bool MEMKV = false>
static int launch_sub_fwd(const SubFwdMaps& mp, const SubFwdArgs& a, int B, cudaStream_t st) {
  using G = SubFwd<PASSES, CROSS, MEMKV>;
  static bool ready = false;
  cudaError_t e = allow_smem(sub_fwd_kernel<PASSES, CROSS, KEEP, MEMKV>, G::SMEM, ready);
  if (e != cudaSuccess) return (int)e;
  sub_fwd_kernel<PASSES, CROSS, KEEP, MEMKV>
      <<<dim3(FWD_D / FWD_DH, B), WG_THREADS, G::SMEM, st>>>(mp, a);
  return (int)cudaGetLastError();
}

// One launch of out_ln_kernel on a's planes ah / al (M, FWD_D) and W_out's
// (FWD_D, FWD_D) in torch's layout; al, wol null at "default".
template <int PASSES>
static int launch_out_ln(const bf16* ah, const bf16* al, const bf16* woh, const bf16* wol,
                         const OutLnArgs& oa, cudaStream_t st) {
  using O = OutLn<PASSES>;
  constexpr int D = FWD_D;
  static bool ready = false;
  cudaError_t e = allow_smem(out_ln_kernel<PASSES>, O::SMEM, ready);
  if (e != cudaSuccess) return (int)e;
  OutLnMaps om;
  int rc;
  if ((rc = kmajor_map(&om.a[0], ah, oa.M, D, 64)) ||
      (rc = kmajor_map(&om.a[1], PASSES == 3 ? al : nullptr, oa.M, D, 64)) ||
      (rc = kmajor_map(&om.w[0], woh, D, D)) ||
      (rc = kmajor_map(&om.w[1], PASSES == 3 ? wol : nullptr, D, D)))
    return rc;
  out_ln_kernel<PASSES><<<(oa.M + 63) / 64, WG_THREADS, O::SMEM, st>>>(om, oa);
  return (int)cudaGetLastError();
}

}  // namespace kit
