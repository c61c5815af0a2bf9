// Per-op attention over (B, T, H, dh) in the precision modes "high"
// (bf16x3) and "default" (one bf16 pass): the forward (kit_attention_tc)
// and the backward (kit_attention_tc_bwd), the bias built in-kernel from the
// 1-D (B, T) masks as attention.cu builds it.
//
// Replaces keypoints_interpolation_transformer_tpu/ops/pallas/attention.py
// under those modes: _attn_kernel (attention_high, attention_default) and
// _attn_bwd_kernel (attention_bwd_high, attention_bwd_default), as
// _fused_fwd and _fused_bwd_pallas call them.  The contract, the TPU
// kernels' mode arithmetic (hi = bf16(x), lo = bf16(x - hi), nearest even;
// a product of two split operands hi hi + hi lo + lo hi at "high", hi hi at
// "default", each term a float32 sum of exact bf16 products):
//   * forward: q' = q * (1/sqrt(dh) * log2(e)) rounded once in float32,
//     then split; k and v split as they are; the scores of a head are
//     k_hi q'_hi + k_hi q'_lo + k_lo q'_hi, then + the bias with its
//     keypad term times log2(e); each row's max m, exp2(s - m), the sum l,
//     p = exp2(s - m) * (1 / l) rounded to ONE bf16 that multiplies v_hi
//     and v_lo (_prob_parts, _prob_dot).  This is attn_modes.cuh's
//     attn_mode_kernel, its operands split in the block from float32;
//   * backward: nothing of the forward is kept (the TPU vjp saves q, k, v
//     and the masks); per head, for a query i and a key j:
//         s_ij  = (q_i . k_j) / sqrt(dh) + bias_ij    (unscaled q's parts,
//                 the bias's keypad term as it is: the natural-exp domain)
//         p_ij  = exp(s_ij - m_i) * (1 / l_i)      (float32, not rounded)
//         dv_j  = sum_i p_ij g_i                   (p split, three passes)
//         gw_ij = v_j . g_i                        (split operands)
//         delta_i = sum_j gw_ij p_ij              (over the float32 p)
//         dl_ij = split(p_ij (gw_ij - delta_i) / sqrt(dh))
//         dq_i  = sum_j dl_ij k_j,  dk_j = sum_i dl_ij q_i
//     The TPU kernel takes the backward only up to T = 512 and XLA's
//     recompute above it, whose dots XLA on the TPU rounds the same way at
//     "high" / "default"; here this kernel runs at every T.
//
// What bounds it on an H100: the mma.sync products.  The forward is 4 B H
// T^2 dh FLOP (three passes at "high" but p v's two); the backward, given
// no softmax statistics, 5 of B H T^2 dh products for the dq side (s and
// gw twice, dq) and 5 for the key side (s, gw, dv, dk), at "high" three
// passes each.  Bytes are q, k, v (and g) read once a block and the
// outputs written once: at B = 64, T = 128 the backward reads 4 and writes
// 3 (B, T, D) tensors.
//
// Design.  The forward is one launch of attn_mode_kernel (a block of 1-4
// warps, 16 query rows a warp of one head of one video, the head's keys in
// shared memory KB at a time, two sweeps: the row statistics, then p v).
// The backward is two launches, each the forward's shape, no atomics:
//   * attn_op_dq_kernel, query-major: a first sweep over the keys takes each
//     row's max, sum and sum of gw exp(s - max) together (a running max; the
//     sums rescaled as it grows), so delta = that sum / l before any key's
//     dl; the second sweep rebuilds s, p and gw per 16 keys, dl as the A
//     fragment of dl k, and dq sums over every key in registers.  It writes
//     each row's (m, 1 / l, delta) for the second kernel;
//   * attn_op_dkv_kernel, key-major: a block owns 16 keys a warp, the
//     queries stream through shared memory QB at a time (q's and g's planes,
//     each query's (m, 1 / l, delta)); per 16 queries s^T and p^T, gw^T, dl^T,
//     then dv += p^T g (p split at "high") and dk += dl^T q.
// Not copied from the TPU kernel: the key-major (T, T) tiles in VMEM, the
// head grouping of the wide softmax, the query padding to blocks of 512, the
// bb row batching, and the T > 512 switch to XLA.
#include <math.h>

#include "attn_modes.cuh"
#include "common.cuh"
#include "grad.cuh"

using namespace kit;

// (A kernel in namespace kit: nvcc's registration stub cannot tell this
// file's anonymous namespace from kit's, which attn_modes.cuh opens.)
namespace kit {

struct AttnOpBwd {
  const float *q, *k, *v, *g;  // (B T, D) rows, row stride ld
  int ld;
  const float *mask, *valid;   // (B, T) or null
  int repeat_inc, add_keypad;
  float scale;                 // 1 / sqrt(dh)
  float *dq, *dk, *dv;         // row stride ld
  float4* rows;                // (B, H, T): each query's (m, 1 / l, delta, 0)
  int T, dh, DP, KB;           // KB: the streamed side's rows a stage
};

// attn_op_dkv_kernel's shared memory: the block's keys of k's and v's
// planes (16 W each), QB queries of q's and g's planes, each query's (m,
// 1 / l, delta).  attn_op_dq_kernel's is attn_modes.cuh's dq_smem.
__host__ __device__ constexpr int op_dkv_smem(int planes, int W, int DP, int QB) {
  return 2 * planes * (32 * W + 2 * QB) * (DP + 8) + 16 * QB;
}

// Key `key`'s bias in the natural-exp domain (_bias_terms_T without its
// log2(e)): (blocked ? NEG : 0) + the keypad term, + NEG on an invalid key;
// .x for a query at or after the key, .y for one before it; -inf past T.
__device__ __forceinline__ float2 key_bias_nat(const float* mask, const float* valid, int key,
                                               int T, int repeat_inc, int add_keypad) {
  float2 b = make_float2(-INFINITY, -INFINITY);
  if (key < T) {
    const float km = mask == nullptr ? 0.f : __ldg(mask + key);
    float open = 0.f, shut = (repeat_inc && km > 0.f) ? NEG : 0.f;
    if (add_keypad) {
      open = open + km;
      shut = shut + km;
    }
    if (valid != nullptr) {
      const float vb = __ldg(valid + key) > 0.f ? 0.f : NEG;
      open = open + vb;
      shut = shut + vb;
    }
    b = make_float2(open, shut);
  }
  return b;
}

// s = d / sqrt(dh) + bias, each step rounded (the TPU kernel's st * scale,
// then + bias).
__device__ __forceinline__ float nat_score(float d, float scale, float bias) {
  return __fadd_rn(__fmul_rn(d, scale), bias);
}

// dq of head blockIdx.y of video blockIdx.z for the blockDim.x / 2 query
// rows from blockIdx.x times that, and their (m, 1 / l, delta) (see the
// note at the top); NO n8 tiles of dq at a time.
template <int PASSES, int NO>
__global__ void __launch_bounds__(128) attn_op_dq_kernel(const AttnOpBwd p) {
  constexpr int PL = PASSES == 3 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int QR = blockDim.x / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, row0 = blockIdx.x * QR, T = p.T, dh = p.dh, DP = p.DP, KB = p.KB;
  const int QLD = DP + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // PL planes of QR x QLD: q
  bf16* Gs = Qs + PL * QR * QLD;                  // PL planes of QR x QLD: g
  bf16* Ks = Gs + PL * QR * QLD;                  // PL planes of KB x QLD
  bf16* Vs = Ks + PL * KB * QLD;
  float2* kbias = reinterpret_cast<float2*>(Vs + PL * KB * QLD);
  const size_t vid = (size_t)blockIdx.z * T;
  const int hc = h * dh;
  stage_split<PL>(Qs, QLD, QR * QLD, p.q, p.ld, vid, hc, row0, QR, T, dh, DP, false, 1.f);
  stage_split<PL>(Gs, QLD, QR * QLD, p.g, p.ld, vid, hc, row0, QR, T, dh, DP, false, 1.f);
  const float* mask = p.mask == nullptr ? nullptr : p.mask + vid;
  const float* valid = p.valid == nullptr ? nullptr : p.valid + vid;
  auto stage_keys = [&](int k0) {
    stage_split<PL>(Ks, QLD, KB * QLD, p.k, p.ld, vid, hc, k0, KB, T, dh, DP, false, 1.f);
    stage_split<PL>(Vs, QLD, KB * QLD, p.v, p.ld, vid, hc, k0, KB, T, dh, DP, false, 1.f);
    for (int j = threadIdx.x; j < KB; j += blockDim.x)
      kbias[j] = key_bias_nat(mask, valid, k0 + j, T, p.repeat_inc, p.add_keypad);
  };
  const bool once = KB >= T;
  if (once) stage_keys(0);
  __syncthreads();
  const int qa = row0 + 16 * warp + g, qb = qa + 8;
  auto sweep = [&](auto&& body) {
    for (int k0 = 0; k0 < T; k0 += KB) {
      if (!once) {
        __syncthreads();
        stage_keys(k0);
        __syncthreads();
      }
      const int nk = min(KB, T - k0);
      for (int j0 = 0; j0 < nk; j0 += 16) body(j0, k0 + j0);
    }
  };
  // the scores (C layout: s[nt][e] is row e < 2 ? qa : qb, key key0 + 8 nt
  // + 2 t + (e & 1)) and gw of 16 keys from the stage's j0: each the three
  // terms in the TPU kernel's order, (k_hi q_hi + k_hi q_lo) + k_lo q_hi
  // and (v_hi g_hi + v_hi g_lo) + v_lo g_hi
  auto scores_gw = [&](float (&s)[2][4], float (&gw)[2][4], int j0, int key0) {
    float hh[2][4], hl[2][4], lh[2][4];
    dots<PASSES>(hh, hl, lh, Qs + 16 * warp * QLD, QR * QLD, Ks + j0 * QLD, KB * QLD, QLD, DP,
                 lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = j0 + 8 * nt + 2 * t + c, key = key0 + 8 * nt + 2 * t + c;
        const float2 b = kbias[j];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          const float d = PASSES == 3 ? (hh[nt][e] + hl[nt][e]) + lh[nt][e] : hh[nt][e];
          s[nt][e] = nat_score(d, p.scale, key > (r == 0 ? qa : qb) ? b.y : b.x);
        }
      }
    dots<PASSES>(hh, hl, lh, Gs + 16 * warp * QLD, QR * QLD, Vs + j0 * QLD, KB * QLD, QLD, DP,
                 lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gw[nt][e] = PASSES == 3 ? (hh[nt][e] + hl[nt][e]) + lh[nt][e] : hh[nt][e];
  };
  // the first sweep: each row's max m, its sum l of exp(s - m) and its sum
  // ds of gw exp(s - m), a lane's running max over its keys (its sums
  // rescaled whenever the max grows), then the quad's four lanes joined
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, ds[2] = {0.f, 0.f};
  sweep([&](int j0, int key0) {
    float s[2][4], gw[2][4];
    scores_gw(s, gw, j0, key0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mx = fmaxf(fmaxf(s[0][2 * i], s[0][2 * i + 1]),
                             fmaxf(s[1][2 * i], s[1][2 * i + 1]));
      const float nm = fmaxf(m[i], mx);
      if (nm == -INFINITY) continue;  // every key of the lane so far past T
      const float f = expf(m[i] - nm);
      float el = 0.f, ed = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float ex = expf(s[nt][2 * i + c] - nm);
          el += ex;
          ed += gw[nt][2 * i + c] * ex;
        }
      l[i] = l[i] * f + el;
      ds[i] = ds[i] * f + ed;
      m[i] = nm;
    }
  });
  float inv[2], delta[2];
  const size_t hrow = ((size_t)blockIdx.z * gridDim.y + h) * T;  // this (video, head)'s rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mq = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));  // finite: key 0 < T
    const float f = m[i] == -INFINITY ? 0.f : expf(m[i] - mq);
    l[i] *= f;
    ds[i] *= f;
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    ds[i] += __shfl_xor_sync(0xffffffffu, ds[i], 1);
    ds[i] += __shfl_xor_sync(0xffffffffu, ds[i], 2);
    m[i] = mq;
    const int row = i == 0 ? qa : qb;
    inv[i] = row < T ? 1.f / l[i] : 0.f;  // a row past T: p = 0
    delta[i] = ds[i] * inv[i];
    if (t == 0 && row < T) p.rows[hrow + row] = make_float4(m[i], inv[i], delta[i], 0.f);
  }
  for (int d0 = 0; d0 < DP; d0 += 8 * NO) {
    const int nto = min(NO, (DP - d0) / 8);
    float dq[NO][4];
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;
    sweep([&](int j0, int key0) {
      float s[2][4], gw[2][4];
      scores_gw(s, gw, j0, key0);
      uint32_t dh_[4], dl_[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p0 = expf(s[nt][2 * r] - m[r]) * inv[r];
          const float p1 = expf(s[nt][2 * r + 1] - m[r]) * inv[r];
          dl_pair(p0, gw[nt][2 * r], delta[r], p1, gw[nt][2 * r + 1], delta[r], p.scale,
                  dh_[2 * nt + r], dl_[2 * nt + r]);
        }
      // dq += dl k: dl_hi k_hi + dl_hi k_lo + dl_lo k_hi
#pragma unroll
      for (int nt = 0; nt < NO; nt += 2) {
        if (nt < nto) {
          uint32_t b[4];
          v_fragments(b, Ks, QLD, j0, d0 + 8 * nt, lane);
          mma16816(dq[nt], dh_, b[0], b[1]);
          mma16816(dq[nt + 1], dh_, b[2], b[3]);
          if (PASSES == 3) {
            mma16816(dq[nt], dl_, b[0], b[1]);
            mma16816(dq[nt + 1], dl_, b[2], b[3]);
            v_fragments(b, Ks + KB * QLD, QLD, j0, d0 + 8 * nt, lane);
            mma16816(dq[nt], dh_, b[0], b[1]);
            mma16816(dq[nt + 1], dh_, b[2], b[3]);
          }
        }
      }
    });
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      if (nt >= nto) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? qa : qb, c = d0 + 8 * nt + 2 * t + (e & 1);
        if (row < T && c < dh) p.dq[(vid + row) * p.ld + hc + c] = dq[nt][e];
      }
    }
  }
}

// dk and dv of head blockIdx.y of video blockIdx.z for the blockDim.x / 2
// keys from blockIdx.x times that (see the note at the top); NO n8 tiles of
// each at a time.
template <int PASSES, int NO>
__global__ void __launch_bounds__(128) attn_op_dkv_kernel(const AttnOpBwd p) {
  constexpr int PL = PASSES == 3 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int KR = blockDim.x / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, key0 = blockIdx.x * KR, T = p.T, dh = p.dh, DP = p.DP, QB = p.KB;
  const int QLD = DP + 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // PL planes of KR x QLD
  bf16* Vs = Ks + PL * KR * QLD;
  bf16* Qs = Vs + PL * KR * QLD;  // PL planes of QB x QLD each: q, g
  bf16* Gs = Qs + PL * QB * QLD;
  float4* qst = reinterpret_cast<float4*>(Gs + PL * QB * QLD);  // (m, 1 / l, delta)
  const size_t vid = (size_t)blockIdx.z * T;
  const int hc = h * dh;
  const size_t hrow = ((size_t)blockIdx.z * gridDim.y + h) * T;
  stage_split<PL>(Ks, QLD, KR * QLD, p.k, p.ld, vid, hc, key0, KR, T, dh, DP, false, 1.f);
  stage_split<PL>(Vs, QLD, KR * QLD, p.v, p.ld, vid, hc, key0, KR, T, dh, DP, false, 1.f);
  const float* mask = p.mask == nullptr ? nullptr : p.mask + vid;
  const float* valid = p.valid == nullptr ? nullptr : p.valid + vid;
  const int ka = key0 + 16 * warp + g, kb = ka + 8;  // the thread's two keys
  const float2 bias[2] = {key_bias_nat(mask, valid, ka, T, p.repeat_inc, p.add_keypad),
                          key_bias_nat(mask, valid, kb, T, p.repeat_inc, p.add_keypad)};
  auto stage_queries = [&](int q0) {
    stage_split<PL>(Qs, QLD, QB * QLD, p.q, p.ld, vid, hc, q0, QB, T, dh, DP, false, 1.f);
    stage_split<PL>(Gs, QLD, QB * QLD, p.g, p.ld, vid, hc, q0, QB, T, dh, DP, false, 1.f);
    for (int i = threadIdx.x; i < QB; i += blockDim.x) {
      const int q = q0 + i;  // a query past T: p = 0
      qst[i] = q < T ? p.rows[hrow + q] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  const bool once = QB >= T;
  if (once) stage_queries(0);
  __syncthreads();
  for (int d0 = 0; d0 < DP; d0 += 8 * NO) {
    const int nto = min(NO, (DP - d0) / 8);
    float dk[NO][4], dv[NO][4];
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;
    for (int q0 = 0; q0 < T; q0 += QB) {
      if (!once) {
        __syncthreads();
        stage_queries(q0);
        __syncthreads();
      }
      const int nq = min(QB, T - q0);
      for (int j0 = 0; j0 < nq; j0 += 16) {
        // s^T = k q^T: A = k, B = q, in the TPU kernel's order
        // (k_hi q_hi + k_hi q_lo) + k_lo q_hi
        float hh[2][4], lk[2][4], lq[2][4], pf[2][4];
        dots<PASSES>(hh, lk, lq, Ks + 16 * warp * QLD, KR * QLD, Qs + j0 * QLD, QB * QLD, QLD,
                     DP, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = e < 2 ? ka : kb, qi = j0 + 8 * nt + 2 * t + (e & 1);
            const float4 qv = qst[qi];
            const float d = PASSES == 3 ? (hh[nt][e] + lq[nt][e]) + lk[nt][e] : hh[nt][e];
            const float s = nat_score(d, p.scale, key > q0 + qi ? bias[e >> 1].y : bias[e >> 1].x);
            pf[nt][e] = expf(s - qv.x) * qv.y;
          }
        // gw^T = v g^T: A = v, B = g, in the order (v_hi g_hi + v_hi g_lo) +
        // v_lo g_hi
        dots<PASSES>(hh, lk, lq, Vs + 16 * warp * QLD, KR * QLD, Gs + j0 * QLD, QB * QLD, QLD,
                     DP, lane);
        uint32_t ph[4], pl[4], dh_[4], dl_[4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float gw[2], dlt[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 2 * r + c;
              gw[c] = PASSES == 3 ? (hh[nt][e] + lq[nt][e]) + lk[nt][e] : hh[nt][e];
              dlt[c] = qst[j0 + 8 * nt + 2 * t + c].z;
            }
            split2(pf[nt][2 * r], pf[nt][2 * r + 1], ph[2 * nt + r], pl[2 * nt + r]);
            dl_pair(pf[nt][2 * r], gw[0], dlt[0], pf[nt][2 * r + 1], gw[1], dlt[1], p.scale,
                    dh_[2 * nt + r], dl_[2 * nt + r]);
          }
#pragma unroll
        for (int nt = 0; nt < NO; nt += 2) {
          if (nt < nto) {
            uint32_t b[4];
            // dv += p^T g: p_hi g_hi + p_hi g_lo + p_lo g_hi
            v_fragments(b, Gs, QLD, j0, d0 + 8 * nt, lane);
            mma16816(dv[nt], ph, b[0], b[1]);
            mma16816(dv[nt + 1], ph, b[2], b[3]);
            if (PASSES == 3) {
              mma16816(dv[nt], pl, b[0], b[1]);
              mma16816(dv[nt + 1], pl, b[2], b[3]);
              v_fragments(b, Gs + QB * QLD, QLD, j0, d0 + 8 * nt, lane);
              mma16816(dv[nt], ph, b[0], b[1]);
              mma16816(dv[nt + 1], ph, b[2], b[3]);
            }
            // dk += dl^T q: dl_hi q_hi + dl_hi q_lo + dl_lo q_hi
            v_fragments(b, Qs, QLD, j0, d0 + 8 * nt, lane);
            mma16816(dk[nt], dh_, b[0], b[1]);
            mma16816(dk[nt + 1], dh_, b[2], b[3]);
            if (PASSES == 3) {
              mma16816(dk[nt], dl_, b[0], b[1]);
              mma16816(dk[nt + 1], dl_, b[2], b[3]);
              v_fragments(b, Qs + QB * QLD, QLD, j0, d0 + 8 * nt, lane);
              mma16816(dk[nt], dh_, b[0], b[1]);
              mma16816(dk[nt + 1], dh_, b[2], b[3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      if (nt >= nto) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? ka : kb, c = d0 + 8 * nt + 2 * t + (e & 1);
        if (key < T && c < dh) {
          const size_t at = (vid + key) * p.ld + hc + c;
          p.dk[at] = dk[nt][e];
          p.dv[at] = dv[nt][e];
        }
      }
    }
  }
}

}  // namespace kit

namespace {

// 1 / sqrt(dh) and the forward's q scale 1 / sqrt(dh) * log2(e), each
// rounded once to float32 from double, as the TPU kernel's constants are.
float inv_sqrt(int dh) { return (float)(1.0 / sqrt((double)dh)); }
float q_scale(int dh) { return (float)((1.0 / sqrt((double)dh)) * 1.4426950408889634); }

template <int PASSES>
int forward(const float* q, const float* k, const float* v, const float* mask,
            const float* valid, int B, int T, int H, int dh, int repeat_inc, int add_keypad,
            float* out, float* stats, cudaStream_t st) {
  AttnMode a{};
  a.q32 = q;
  a.k32 = k;
  a.v32 = v;
  a.qs = q_scale(dh);
  a.ldq = a.ldkv = a.ldo = H * dh;
  a.mask = mask;
  a.valid = valid;
  a.repeat_inc = repeat_inc;
  a.add_keypad = add_keypad;
  a.a32 = out;
  a.stats = stats;
  a.T = T;
  a.dh = dh;
  return attend<PASSES>(a, B, H, st);
}

template <int PASSES>
int backward(AttnOpBwd a, int B, int H, cudaStream_t st) {
  constexpr int PL = PASSES == 3 ? 2 : 1;
  a.DP = round_up(a.dh, 16);
  const bool narrow = a.DP <= 32;
  static bool ready[4] = {false, false, false, false};
  auto dq = narrow ? attn_op_dq_kernel<PASSES, 4> : attn_op_dq_kernel<PASSES, 8>;
  auto dkv = narrow ? attn_op_dkv_kernel<PASSES, 4> : attn_op_dkv_kernel<PASSES, 8>;
  cudaError_t e = allow_smem(dq, ATTN_SMEM, ready[narrow ? 0 : 1]);
  if (e == cudaSuccess) e = allow_smem(dkv, ATTN_SMEM, ready[narrow ? 2 : 3]);
  if (e != cudaSuccess) return (int)e;
  int W, rows;
  if (!attn_geometry(a.T, [&](int w, int kb) { return dq_smem(PL, w, a.DP, kb); }, W, rows))
    return (int)cudaErrorInvalidValue;
  a.KB = rows;
  dq<<<dim3((a.T + 16 * W - 1) / (16 * W), H, B), 32 * W, dq_smem(PL, W, a.DP, rows), st>>>(a);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  if (!attn_geometry(a.T, [&](int w, int qb) { return op_dkv_smem(PL, w, a.DP, qb); }, W, rows))
    return (int)cudaErrorInvalidValue;
  a.KB = rows;
  dkv<<<dim3((a.T + 16 * W - 1) / (16 * W), H, B), 32 * W, op_dkv_smem(PL, W, a.DP, rows),
        st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out (B*T, H*DH) rows in mode passes (3 "high", 1 "default");
// mask, valid (B, T), either null where not read (mask: kind "all" without
// keypad; valid: every key real); stats (B, H, T, 2), each row's
// log2-domain (m, l), or null.  DH is 1 to 512; where it is a multiple of 8
// the rows are read as float4 (16-byte aligned).
extern "C" int kit_attention_tc(int passes, const void* q, const void* k, const void* v,
                                const void* mask, const void* valid, int B, int T, int H, int DH,
                                int repeat_inc, int add_keypad, void* out, void* stats,
                                void* stream) {
  if (passes != 1 && passes != 3) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return 0;
  auto f = passes == 3 ? forward<3> : forward<1>;
  return f((const float*)q, (const float*)k, (const float*)v, (const float*)mask,
           (const float*)valid, B, T, H, DH, repeat_inc, add_keypad, (float*)out,
           (float*)stats, (cudaStream_t)stream);
}

// dq, dk, dv (B*T, H*DH) from q, k, v, g = dL/dout and the masks as
// kit_attention_tc took them; rows: 4 B H T floats of scratch (each query's
// (m, 1 / l, delta)).  Two launches, no atomics.
extern "C" int kit_attention_tc_bwd(int passes, const void* q, const void* k, const void* v,
                                    const void* g, const void* mask, const void* valid, int B,
                                    int T, int H, int DH, int repeat_inc, int add_keypad,
                                    void* dq, void* dk, void* dv, void* rows, void* stream) {
  if (passes != 1 && passes != 3) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return 0;
  AttnOpBwd a{};
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.g = (const float*)g;
  a.ld = H * DH;
  a.mask = (const float*)mask;
  a.valid = (const float*)valid;
  a.repeat_inc = repeat_inc;
  a.add_keypad = add_keypad;
  a.scale = inv_sqrt(DH);
  a.dq = (float*)dq;
  a.dk = (float*)dk;
  a.dv = (float*)dv;
  a.rows = (float4*)rows;
  a.T = T;
  a.dh = DH;
  auto f = passes == 3 ? backward<3> : backward<1>;
  return f(a, B, H, (cudaStream_t)stream);
}
