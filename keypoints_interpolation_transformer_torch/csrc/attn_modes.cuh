// The attention core of the precision modes "high" (bf16x3) and "default"
// (one bf16 pass) on mma.sync m16n8k16, and the launches around it: the
// forward (attn_mode_kernel; layer_modes.cu's merged layers and
// attn_sublayer_modes.cu's sublayer) and the two kernels of the sublayer's
// backward (attn_mode_dq_kernel, attn_mode_dkv_kernel).  The contract is
// the TPU kernels' mode arithmetic (keypoints_interpolation_transformer_tpu/
// ops/pallas/attention.py _prep / _dot / _prob_parts / _prob_dot, as
// attn_sublayer.py's _attn_core and _sublayer_bwd_kernel take them):
//   * hi = bf16(x), lo = bf16(x - hi), both rounded to nearest even; a
//     product of two split operands is hi hi + hi lo + lo hi ("high"), each
//     term a float32 sum of exact bf16 products, or hi hi ("default");
//   * the scores of a head are k q^T from the planes of q scaled by
//     log2(e) / sqrt(dh), then + the bias (its keypad term times log2(e)),
//     so the softmax runs on exp2: each row's max m, exp2(s - m), its sum
//     l, then p = exp2(s - m) * (1 / l), rounded to ONE bf16 that
//     multiplies v's planes (p v_hi + p v_lo; "default" p v_hi).
//
// The forward (see layer_modes.cu's note for its place in a layer): a block
// of 1-4 warps owns 16 query rows a warp of one head of one video; q's
// planes for them, and the head's k and v planes for KB keys at a time (all
// T when they fit) with each key's bias, sit in shared memory, rows padded
// so that fragment loads meet no bank conflict (v's B fragments come
// transposed by ldmatrix).  The head width is padded with zeros to DP, a
// multiple of 16 (the k of m16n8k16).  Two sweeps over the keys, each
// recomputing the scores of 16 keys at a time from the planes (the three
// terms in their own accumulators, added as the TPU kernel adds its three
// dots): the row's max and its sum of exp2(s - max) (a running max, the
// sum rescaled as it grows), then per 32 or 64 output columns p as the A
// fragment of p v_hi and p v_lo.  For training it also writes each (row,
// head)'s (m, l), the log2-domain statistics the backward rebuilds p from,
// and the float32 output a.
//
// The backward, given dA = dL/da as planes, the forward's float32 q
// (unscaled), k, v, a and its statistics.  The TPU kernel's per-head steps
// (_sublayer_bwd_kernel, recompute branch) for a query i and a key j:
//     p_ij  = bf16(exp2(s_ij - m_i) / l_i)       (the forward's very p)
//     dv_j  = sum_i p_ij dA_i                     (p against dA's planes)
//     gw_ij = v_j . dA_i                          (split operands)
//     dl_ij = split(p_ij (gw_ij - delta_i) / sqrt(dh))
//     dq_i  = sum_j dl_ij k_j,  dk_j = sum_i dl_ij q_i   (q unscaled)
// where the TPU kernel sums delta_i = sum_j gw_ij p_ij over the keys.  Here
// delta_i = sum_d (dA_hi + dA_lo)_id a_id, over the forward's float32 a:
// at "default" that is the same sum in another order (a = sum_j p_ij
// v_hi,j), at "high" it adds the lo lo term the three products drop, some
// 2^-16 of delta.  So one key-side pass needs no query-side sweep first.
// Two kernels, each the forward's shape and no atomics anywhere:
//   * attn_mode_dq_kernel, query-major (the forward's blocks): delta_i, then
//     per 16 keys s and p exactly as the forward computes them (the same
//     fragments, the same sum of the terms), gw, dl in registers as the A
//     fragment of dl k (k's B fragments transposed by ldmatrix), dq summed
//     over every key in registers and written once; it also writes delta;
//   * attn_mode_dkv_kernel, key-major: a block of 1-4 warps owns 16 keys a
//     warp; the queries stream through shared memory QB at a time (planes
//     of q s for the scores, of q for dk, of dA, and each query's m, 1 / l
//     and delta); per 16 queries s^T = k (q s)^T (the same products, the
//     terms added in the forward's order), p^T and dl^T are the A
//     fragments of dv += p^T dA and dk += dl^T q.
// Each kernel walks the output 32 or 64 columns at a time, its sweep
// repeated per chunk above dh = 64.  What bounds them on an H100: the
// mma.sync products, 9 of B H T^2 dh a pass at "high" in the first (s, gw,
// dq), 11 in the second (s, gw, dv, dk), against the forward's 8.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "grad.cuh"
#include "mma_bf16.cuh"
#include "tc_gemm.cuh"

namespace kit {
namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int ATTN_SMEM = 232448;  // an H100 block's dynamic shared memory

struct AttnMode {      // one attention core in a mode
  const bf16 *qh, *ql;  // q's planes: head h of row t of video b at (b T + t) ldq + h dh
  const bf16 *kh, *kl;  // k's and v's planes, row stride ldkv
  const bf16 *vh, *vl;
  int ldq, ldkv;
  const float* mask;    // (B, T) or null
  const float* valid;   // (B, T) or null: every key valid
  int repeat_inc, add_keypad;
  bf16 *oh, *ol;        // the output's planes, row stride ldo
  int ldo;
  int T, dh, DP, KB;    // DP: dh rounded up to 16; KB: keys a stage, a multiple of 16
  float* stats;         // null, or (B, H, T, 2): each row's (m, l), log2 domain
  float* a32;           // null, or the float32 output, row stride ldo
};

// d += a b, m16n8k16, bf16 in, float32 accumulate; a the A fragment (4
// registers), b0 / b1 the B fragment.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The shared memory of attn_mode_kernel: q's planes (16 W rows), and KB
// keys of k's and of v's planes, every row DP + 8 wide (a row of 4 mod 8
// words keeps a fragment's 32 loads on 32 banks, and 16-byte rows serve
// ldmatrix), then each key's bias (two floats).
__host__ __device__ constexpr int attn_smem(int planes, int W, int DP, int KB) {
  return 2 * planes * (16 * W + 2 * KB) * (DP + 8) + 8 * KB;
}

// The B fragments of two n8 tiles of p v: v's rows j0 .. j0 + 15 (the k of
// m16n8k16) at columns d0 .. d0 + 15 of a row-major tile (row stride ld),
// transposed by ldmatrix: {b0, b1} of columns d0 .., then of d0 + 8 ...
__device__ __forceinline__ void v_fragments(uint32_t (&b)[4], const bf16* V, int ld, int j0,
                                            int d0, int lane) {
  const bf16* row = V + (j0 + (lane & 15)) * ld + d0 + 8 * (lane >> 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_u32(row)));
}

// Key `key`'s bias (the order of _bias_terms_T): (blocked ? NEG : 0), + the
// keypad term times log2(e), + NEG on an invalid key; .x for a query at or
// after the key, .y for one before it; -inf for a key past T, so that it
// weighs nothing.  mask and valid point at the video's rows (or are null).
__device__ __forceinline__ float2 key_bias(const float* mask, const float* valid, int key, int T,
                                           int repeat_inc, int add_keypad) {
  float2 b = make_float2(-INFINITY, -INFINITY);
  if (key < T) {
    const float km = mask == nullptr ? 0.f : __ldg(mask + key);
    float open = 0.f, shut = (repeat_inc && km > 0.f) ? NEG : 0.f;
    if (add_keypad) {
      open = open + km * LOG2E;
      shut = shut + km * LOG2E;
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

// Rows first .. first + rows - 1 of the head's DP columns (from column hc,
// dh wide) of a matrix's bf16 planes sh / sl (row stride ld, the video's
// rows from vid) into dst's planes (row stride LD, plane stride pstride),
// zero past T and dh; 8 columns a chunk, four chunks a thread in flight.
template <int PL>
__device__ __forceinline__ void stage_planes(bf16* dst, int LD, int pstride, const bf16* sh,
                                             const bf16* sl, int ld, size_t vid, int hc, int first,
                                             int rows, int T, int dh, int DP) {
  const bool vec = dh % 8 == 0;  // 16-byte rows: whole 8-column chunks
  const int cpr = DP / 8, n = rows * cpr;
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * blockDim.x) {
    uint4 vh[4], vl[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      vh[u] = vl[u] = make_uint4(0u, 0u, 0u, 0u);
      const int i = i0 + u * blockDim.x;
      if (i >= n) continue;
      const int r = i / cpr, c = 8 * (i - r * cpr), row = first + r;
      if (row >= T || c >= dh) continue;
      const size_t o = (vid + row) * ld + hc + c;
      if (vec) {
        vh[u] = __ldg(reinterpret_cast<const uint4*>(sh + o));
        if (PL == 2) vl[u] = __ldg(reinterpret_cast<const uint4*>(sl + o));
      } else {  // one value at a time, packed in registers
        uint32_t wh[4] = {0u, 0u, 0u, 0u}, wl[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (c + e >= dh) break;
          wh[e >> 1] |= (uint32_t)__bfloat16_as_ushort(sh[o + e]) << (16 * (e & 1));
          if (PL == 2) wl[e >> 1] |= (uint32_t)__bfloat16_as_ushort(sl[o + e]) << (16 * (e & 1));
        }
        vh[u] = make_uint4(wh[0], wh[1], wh[2], wh[3]);
        vl[u] = make_uint4(wl[0], wl[1], wl[2], wl[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i >= n) continue;
      const int r = i / cpr, c = 8 * (i - r * cpr);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = vh[u];
      if (PL == 2) *reinterpret_cast<uint4*>(dst + pstride + r * LD + c) = vl[u];
    }
  }
}

// As stage_planes, from a float32 matrix (row stride ld) split here, each
// value first multiplied by `scale` when `scaled` (__fmul_rn: the product
// rounded once, as the forward rounds it before its split).
template <int PL>
__device__ __forceinline__ void stage_split(bf16* dst, int LD, int pstride, const float* src,
                                            int ld, size_t vid, int hc, int first, int rows, int T,
                                            int dh, int DP, bool scaled, float scale) {
  const bool vec = dh % 8 == 0;
  const int cpr = DP / 8, n = rows * cpr;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / cpr, c = 8 * (i - r * cpr), row = first + r;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.f;
    if (row < T && c < dh) {
      const float* s = src + (vid + row) * ld + hc + c;
      if (vec) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(s));
        const float4 b = __ldg(reinterpret_cast<const float4*>(s + 4));
        v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
        v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
      } else {
        for (int e = 0; e < 8 && c + e < dh; ++e) v[e] = __ldg(s + e);
      }
      if (scaled)
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(v[e], scale);
    }
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split2(v[2 * e], v[2 * e + 1], h[e], l[e]);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = make_uint4(h[0], h[1], h[2], h[3]);
    if (PL == 2) *reinterpret_cast<uint4*>(dst + pstride + r * LD + c) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The three (or one) products of a 16-row A tile and two n8 tiles of B
// rows, both row-major in shared memory (row stride LD, plane strides apl /
// bpl), over DP / 16 steps of 16: hh = A_hi B_hi, al = A_lo B_hi, bl =
// A_hi B_lo, each in its own accumulator; the C layout: t[nt][e] is A row
// (e < 2 ? g : g + 8), B row 8 nt + 2 t + (e & 1).
template <int PASSES>
__device__ __forceinline__ void dots(float (&hh)[2][4], float (&al)[2][4], float (&bl)[2][4],
                                     const bf16* A, int apl, const bf16* Bm, int bpl, int LD,
                                     int DP, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) hh[nt][e] = al[nt][e] = bl[nt][e] = 0.f;
  for (int ks = 0; ks < DP / 16; ++ks) {
    const bf16* ap = A + g * LD + 16 * ks + 2 * t;
    const uint32_t ah[4] = {ld32(ap), ld32(ap + 8 * LD), ld32(ap + 8), ld32(ap + 8 * LD + 8)};
    uint32_t alo[4] = {0u, 0u, 0u, 0u};
    if (PASSES == 3) {
      const bf16* lp = ap + apl;
      alo[0] = ld32(lp);
      alo[1] = ld32(lp + 8 * LD);
      alo[2] = ld32(lp + 8);
      alo[3] = ld32(lp + 8 * LD + 8);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const bf16* bp = Bm + (8 * nt + g) * LD + 16 * ks + 2 * t;
      const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
      mma16816(hh[nt], ah, b0, b1);
      if (PASSES == 3) {
        const bf16* bq = bp + bpl;
        mma16816(al[nt], alo, b0, b1);
        mma16816(bl[nt], ah, ld32(bq), ld32(bq + 8));
      }
    }
  }
}

// The attention core of head blockIdx.y of video blockIdx.z for the
// blockDim.x / 2 query rows from blockIdx.x times that (see the note at the
// top): out = softmax(q k^T + bias) v in the mode's passes, written as the
// output's hi / lo planes at the head's dh columns (rows < T only) and, when
// asked, in float32 with each row's statistics; NO n8 tiles (8 NO columns)
// of the output at a time.
template <int PASSES, int NO>
__global__ void __launch_bounds__(128) attn_mode_kernel(const AttnMode p) {
  constexpr int PL = PASSES == 3 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int QR = blockDim.x / 2;  // 16 rows a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, row0 = blockIdx.x * QR, T = p.T, dh = p.dh, DP = p.DP, KB = p.KB;
  const int QLD = DP + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // PL planes of QR x QLD
  bf16* Ks = Qs + PL * QR * QLD;                  // PL planes of KB x QLD
  bf16* Vs = Ks + PL * KB * QLD;                  // PL planes of KB x QLD
  // key j's bias for a query at or after it, and for one before it
  float2* kbias = reinterpret_cast<float2*>(Vs + PL * KB * QLD);
  const size_t vid = (size_t)blockIdx.z * T;
  const int hc = h * dh;  // the head's first column
  stage_planes<PL>(Qs, QLD, QR * QLD, p.qh, p.ql, p.ldq, vid, hc, row0, QR, T, dh, DP);
  const float* mask = p.mask == nullptr ? nullptr : p.mask + vid;
  const float* valid = p.valid == nullptr ? nullptr : p.valid + vid;
  auto stage_keys = [&](int k0) {
    stage_planes<PL>(Ks, QLD, KB * QLD, p.kh, p.kl, p.ldkv, vid, hc, k0, KB, T, dh, DP);
    stage_planes<PL>(Vs, QLD, KB * QLD, p.vh, p.vl, p.ldkv, vid, hc, k0, KB, T, dh, DP);
    for (int j = threadIdx.x; j < KB; j += blockDim.x)
      kbias[j] = key_bias(mask, valid, k0 + j, T, p.repeat_inc, p.add_keypad);
  };
  const int qa = row0 + 16 * warp + g, qb = qa + 8;  // the thread's two query rows
  // s = the scores of keys key0 + 16 (this stage's j0 ..) in the C layout:
  // s[nt][e] is row (e < 2 ? qa : qb), key key0 + 8 nt + 2 t + (e & 1);
  // -inf past T.  The terms added as the TPU kernel adds its three dots,
  // (q_hi k_hi + q_lo k_hi) + q_hi k_lo; then the bias.
  auto scores = [&](float (&s)[2][4], int j0, int key0) {
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
          s[nt][e] = d + (key > (r == 0 ? qa : qb) ? b.y : b.x);
        }
      }
  };
  const bool once = KB >= T;  // every key in one stage
  if (once) stage_keys(0);
  __syncthreads();
  // one sweep over the keys, 16 at a time, body(s, j0) on their scores
  auto sweep = [&](auto&& body) {
    for (int k0 = 0; k0 < T; k0 += KB) {
      if (!once) {
        __syncthreads();  // the previous stage is read
        stage_keys(k0);
        __syncthreads();
      }
      const int nk = min(KB, T - k0);
      for (int j0 = 0; j0 < nk; j0 += 16) {
        float s[2][4];
        scores(s, j0, k0 + j0);
        body(s, j0);
      }
    }
  };
  // each row's max and its sum of exp2(s - max), in one sweep: a lane's
  // running max over its keys, its sum rescaled whenever the max grows,
  // then the quad's four lanes (the row's other keys) joined
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  sweep([&](float (&s)[2][4], int) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mx = fmaxf(fmaxf(s[0][2 * i], s[0][2 * i + 1]),
                             fmaxf(s[1][2 * i], s[1][2 * i + 1]));
      const float nm = fmaxf(m[i], mx);
      if (nm == -INFINITY) continue;  // every key of the lane so far past T
      const float add = (exp2f(s[0][2 * i] - nm) + exp2f(s[0][2 * i + 1] - nm)) +
                        (exp2f(s[1][2 * i] - nm) + exp2f(s[1][2 * i + 1] - nm));
      l[i] = l[i] * exp2f(m[i] - nm) + add;
      m[i] = nm;
    }
  });
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mq = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));  // finite: key 0 < T
    l[i] = l[i] * exp2f(m[i] - mq);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    m[i] = mq;
  }
  if (p.stats != nullptr && t == 0) {  // the quad's lanes hold the same (m, l)
    float* st = p.stats + ((size_t)blockIdx.z * gridDim.y + h) * T * 2;
    if (qa < T) *reinterpret_cast<float2*>(st + 2 * qa) = make_float2(m[0], l[0]);
    if (qb < T) *reinterpret_cast<float2*>(st + 2 * qb) = make_float2(m[1], l[1]);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  for (int d0 = 0; d0 < DP; d0 += 8 * NO) {
    const int nto = min(NO, (DP - d0) / 8);  // n8 tiles of this chunk of the output
    float oh[NO][4], ol[NO][4];
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oh[nt][e] = ol[nt][e] = 0.f;
    sweep([&](float (&s)[2][4], int j0) {
      // p = exp2(s - max) (1 / sum), one bf16 each, as the A fragment of
      // the 16 keys: the two n8 score tiles side by side
      float pr[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) pr[nt][e] = exp2f(s[nt][e] - m[e >> 1]) * inv[e >> 1];
      const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]), pack_bf16(pr[0][2], pr[0][3]),
                              pack_bf16(pr[1][0], pr[1][1]), pack_bf16(pr[1][2], pr[1][3])};
#pragma unroll
      for (int nt = 0; nt < NO; nt += 2) {
        if (nt < nto) {  // nto is even: DP is a multiple of 16
          uint32_t b[4];
          v_fragments(b, Vs, QLD, j0, d0 + 8 * nt, lane);
          mma16816(oh[nt], pa, b[0], b[1]);  // p v_hi
          mma16816(oh[nt + 1], pa, b[2], b[3]);
          if (PASSES == 3) {
            v_fragments(b, Vs + KB * QLD, QLD, j0, d0 + 8 * nt, lane);
            mma16816(ol[nt], pa, b[0], b[1]);  // p v_lo
            mma16816(ol[nt + 1], pa, b[2], b[3]);
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
        if (row >= T || c >= dh) continue;
        const float o = PASSES == 3 ? oh[nt][e] + ol[nt][e] : oh[nt][e];
        const bf16 hi = __float2bfloat16_rn(o);
        const size_t at = (vid + row) * p.ldo + hc + c;
        p.oh[at] = hi;
        if (PASSES == 3) p.ol[at] = __float2bfloat16_rn(o - __bfloat162float(hi));
        if (p.a32 != nullptr) p.a32[at] = o;
      }
    }
  }
}

// The smallest stage that fits: W warps (4, else fewer for the widest
// heads) and the most rows of the streamed side a stage (all where they
// fit), a multiple of 16, given the bytes smem(W, rows) a build takes.
template <typename Smem>
bool attn_geometry(int T, Smem smem, int& W, int& rows) {
  const int Tr = round_up(T, 16);
  for (W = 4; W >= 1; W /= 2) {
    for (rows = Tr; rows > 16 && smem(W, rows) > ATTN_SMEM; rows -= 16) {
    }
    if (smem(W, rows) <= ATTN_SMEM) return true;
  }
  return false;
}

template <int PASSES>
int attend(AttnMode a, int B, int H, cudaStream_t st) {
  constexpr int PL = PASSES == 3 ? 2 : 1;
  a.DP = round_up(a.dh, 16);
  // the output 32 columns at a time up to dh = 32 (half the accumulators),
  // else 64
  static bool ready4 = false, ready8 = false;
  auto kernel = a.DP <= 32 ? attn_mode_kernel<PASSES, 4> : attn_mode_kernel<PASSES, 8>;
  cudaError_t e = allow_smem(kernel, ATTN_SMEM, a.DP <= 32 ? ready4 : ready8);
  if (e != cudaSuccess) return (int)e;
  // four warps a block, with as many keys a stage as fit (every key where
  // they do); fewer warps only for the widest heads
  int W, KB;
  if (!attn_geometry(a.T, [&](int w, int kb) { return attn_smem(PL, w, a.DP, kb); }, W, KB))
    return (int)cudaErrorInvalidValue;
  a.KB = KB;
  const dim3 grid((a.T + 16 * W - 1) / (16 * W), H, B);
  kernel<<<grid, 32 * W, attn_smem(PL, W, a.DP, KB), st>>>(a);
  return (int)cudaGetLastError();
}

// ---- the backward -------------------------------------------------------------

struct AttnModeBwd {
  const float *q, *k, *v;  // the forward's float32 q (unscaled), k, v, row stride ldqkv
  int ldqkv;
  const bf16 *dah, *dal;   // dA's planes, row stride ld
  const float* a;          // the forward's float32 output, row stride ld
  int ld;
  const float* stats;      // (B, H, T, 2): (m, l), log2 domain
  const float *mask, *valid;
  int repeat_inc, add_keypad;
  float qs, scale;         // the forward's q scale log2(e) / sqrt(dh); 1 / sqrt(dh)
  float *dq, *dk, *dv;     // row stride ldg
  int ldg;
  float* delta;            // (B, H, T)
  int T, dh, DP, KB;       // KB: the streamed side's rows a stage, a multiple of 16
};

// attn_mode_dq_kernel's shared memory: the block's rows of q s's planes and
// of dA's (16 W each), KB keys of k's and v's planes, each key's bias.
__host__ __device__ constexpr int dq_smem(int planes, int W, int DP, int KB) {
  return 2 * planes * (32 * W + 2 * KB) * (DP + 8) + 8 * KB;
}

// attn_mode_dkv_kernel's shared memory: the block's keys of k's and v's
// planes (16 W each), QB queries of the planes of q s, q and dA, and each
// query's (m, 1 / l, delta).
__host__ __device__ constexpr int dkv_smem(int planes, int W, int DP, int QB) {
  return 2 * planes * (32 * W + 3 * QB) * (DP + 8) + 16 * QB;
}

// split of (pf (g - delta)) / sqrt(dh), two values, as hi and lo bf16
// pairs (the products rounded once each, as the TPU kernel rounds them).
__device__ __forceinline__ void dl_pair(float p0, float g0, float d0, float p1, float g1, float d1,
                                        float scale, uint32_t& hi, uint32_t& lo) {
  split2(__fmul_rn(__fmul_rn(p0, g0 - d0), scale), __fmul_rn(__fmul_rn(p1, g1 - d1), scale), hi,
         lo);
}

// bf16 p back to float (the value the products consume).
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// dq of head blockIdx.y of video blockIdx.z for the blockDim.x / 2 query
// rows from blockIdx.x times that, and their delta (see the note at the
// top); NO n8 tiles of dq at a time.
template <int PASSES, int NO>
__global__ void __launch_bounds__(128) attn_mode_dq_kernel(const AttnModeBwd p) {
  constexpr int PL = PASSES == 3 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int QR = blockDim.x / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, row0 = blockIdx.x * QR, T = p.T, dh = p.dh, DP = p.DP, KB = p.KB;
  const int QLD = DP + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // PL planes of QR x QLD: q s
  bf16* Ds = Qs + PL * QR * QLD;                  // PL planes of QR x QLD: dA
  bf16* Ks = Ds + PL * QR * QLD;                  // PL planes of KB x QLD
  bf16* Vs = Ks + PL * KB * QLD;
  float2* kbias = reinterpret_cast<float2*>(Vs + PL * KB * QLD);
  const size_t vid = (size_t)blockIdx.z * T;
  const int hc = h * dh;
  stage_split<PL>(Qs, QLD, QR * QLD, p.q, p.ldqkv, vid, hc, row0, QR, T, dh, DP, true, p.qs);
  stage_planes<PL>(Ds, QLD, QR * QLD, p.dah, p.dal, p.ld, vid, hc, row0, QR, T, dh, DP);
  const float* mask = p.mask == nullptr ? nullptr : p.mask + vid;
  const float* valid = p.valid == nullptr ? nullptr : p.valid + vid;
  auto stage_keys = [&](int k0) {
    stage_split<PL>(Ks, QLD, KB * QLD, p.k, p.ldqkv, vid, hc, k0, KB, T, dh, DP, false, 1.f);
    stage_split<PL>(Vs, QLD, KB * QLD, p.v, p.ldqkv, vid, hc, k0, KB, T, dh, DP, false, 1.f);
    for (int j = threadIdx.x; j < KB; j += blockDim.x)
      kbias[j] = key_bias(mask, valid, k0 + j, T, p.repeat_inc, p.add_keypad);
  };
  const bool once = KB >= T;
  if (once) stage_keys(0);
  __syncthreads();
  const int qa = row0 + 16 * warp + g, qb = qa + 8;
  const size_t hrow = ((size_t)blockIdx.z * gridDim.y + h) * T;  // this (video, head)'s rows
  // delta of the warp's 16 rows: sum over d of (dA_hi + dA_lo) a, the lanes
  // over d, then the warp's sum; lane 0 writes it for the second kernel
  float delta[2] = {0.f, 0.f};
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + 16 * warp + r;
    float s = 0.f;
    if (row < T)
      for (int d = lane; d < dh; d += 32) {
        const bf16* dp = Ds + (16 * warp + r) * QLD + d;
        const float da = PL == 2 ? __bfloat162float(dp[0]) + __bfloat162float(dp[QR * QLD])
                                 : __bfloat162float(dp[0]);
        s = fmaf(da, __ldg(p.a + (vid + row) * p.ld + hc + d), s);
      }
    s = warp_sum(s);
    if (r == g) delta[0] = s;
    if (r == g + 8) delta[1] = s;
    if (lane == 0 && row < T) p.delta[hrow + row] = s;
  }
  float m[2], inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? qa : qb;
    m[i] = 0.f;
    inv[i] = 0.f;  // a row past T: p = 0
    if (row < T) {
      const float2 ml = __ldg(reinterpret_cast<const float2*>(p.stats + 2 * (hrow + row)));
      m[i] = ml.x;
      inv[i] = 1.f / ml.y;
    }
  }
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
  for (int d0 = 0; d0 < DP; d0 += 8 * NO) {
    const int nto = min(NO, (DP - d0) / 8);
    float dq[NO][4];
#pragma unroll
    for (int nt = 0; nt < NO; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;
    sweep([&](int j0, int key0) {
      // p exactly as the forward computes it
      float hh[2][4], hl[2][4], lh[2][4], pf[2][4];
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
            const float s = d + (key > (r == 0 ? qa : qb) ? b.y : b.x);
            pf[nt][e] = bf16_round(exp2f(s - m[r]) * inv[r]);
          }
        }
      // gw = v dA^T in the TPU kernel's order, (v_hi dA_hi + v_hi dA_lo) +
      // v_lo dA_hi: here A = dA, B = v
      dots<PASSES>(hh, hl, lh, Ds + 16 * warp * QLD, QR * QLD, Vs + j0 * QLD, KB * QLD, QLD, DP,
                   lane);
      uint32_t dh_[4], dl_[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float gw[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * r + c;
            gw[c] = PASSES == 3 ? (hh[nt][e] + hl[nt][e]) + lh[nt][e] : hh[nt][e];
          }
          dl_pair(pf[nt][2 * r], gw[0], delta[r], pf[nt][2 * r + 1], gw[1], delta[r], p.scale,
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
        if (row < T && c < dh) p.dq[(vid + row) * p.ldg + hc + c] = dq[nt][e];
      }
    }
  }
}

// dk and dv of head blockIdx.y of video blockIdx.z for the blockDim.x / 2
// keys from blockIdx.x times that (see the note at the top); NO n8 tiles of
// each at a time.
template <int PASSES, int NO>
__global__ void __launch_bounds__(128) attn_mode_dkv_kernel(const AttnModeBwd p) {
  constexpr int PL = PASSES == 3 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int KR = blockDim.x / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, key0 = blockIdx.x * KR, T = p.T, dh = p.dh, DP = p.DP, QB = p.KB;
  const int QLD = DP + 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // PL planes of KR x QLD
  bf16* Vs = Ks + PL * KR * QLD;
  bf16* Qs = Vs + PL * KR * QLD;  // PL planes of QB x QLD each: q s, q, dA
  bf16* Qu = Qs + PL * QB * QLD;
  bf16* Ds = Qu + PL * QB * QLD;
  float4* qst = reinterpret_cast<float4*>(Ds + PL * QB * QLD);  // (m, 1 / l, delta)
  const size_t vid = (size_t)blockIdx.z * T;
  const int hc = h * dh;
  const size_t hrow = ((size_t)blockIdx.z * gridDim.y + h) * T;
  stage_split<PL>(Ks, QLD, KR * QLD, p.k, p.ldqkv, vid, hc, key0, KR, T, dh, DP, false, 1.f);
  stage_split<PL>(Vs, QLD, KR * QLD, p.v, p.ldqkv, vid, hc, key0, KR, T, dh, DP, false, 1.f);
  const float* mask = p.mask == nullptr ? nullptr : p.mask + vid;
  const float* valid = p.valid == nullptr ? nullptr : p.valid + vid;
  const int ka = key0 + 16 * warp + g, kb = ka + 8;  // the thread's two keys
  const float2 bias[2] = {key_bias(mask, valid, ka, T, p.repeat_inc, p.add_keypad),
                          key_bias(mask, valid, kb, T, p.repeat_inc, p.add_keypad)};
  auto stage_queries = [&](int q0) {
    stage_split<PL>(Qs, QLD, QB * QLD, p.q, p.ldqkv, vid, hc, q0, QB, T, dh, DP, true, p.qs);
    stage_split<PL>(Qu, QLD, QB * QLD, p.q, p.ldqkv, vid, hc, q0, QB, T, dh, DP, false, 1.f);
    stage_planes<PL>(Ds, QLD, QB * QLD, p.dah, p.dal, p.ld, vid, hc, q0, QB, T, dh, DP);
    for (int i = threadIdx.x; i < QB; i += blockDim.x) {
      const int q = q0 + i;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);  // a query past T: p = 0
      if (q < T) {
        const float2 ml = __ldg(reinterpret_cast<const float2*>(p.stats + 2 * (hrow + q)));
        v = make_float4(ml.x, 1.f / ml.y, p.delta[hrow + q], 0.f);
      }
      qst[i] = v;
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
        // s^T = k (q s)^T: A = k, B = q s; the terms added in the forward's
        // order, (q_hi k_hi + q_lo k_hi) + q_hi k_lo
        float hh[2][4], lq[2][4], lk[2][4], pf[2][4];
        dots<PASSES>(hh, lk, lq, Ks + 16 * warp * QLD, KR * QLD, Qs + j0 * QLD, QB * QLD, QLD,
                     DP, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = e < 2 ? ka : kb, qi = j0 + 8 * nt + 2 * t + (e & 1);
            const float4 qv = qst[qi];
            const float d = PASSES == 3 ? (hh[nt][e] + lq[nt][e]) + lk[nt][e] : hh[nt][e];
            const float s = d + (key > q0 + qi ? bias[e >> 1].y : bias[e >> 1].x);
            pf[nt][e] = bf16_round(exp2f(s - qv.x) * qv.y);
          }
        // gw^T = v dA^T: A = v, B = dA, in the order of the TPU kernel's
        // (v_hi dA_hi + v_hi dA_lo) + v_lo dA_hi
        dots<PASSES>(hh, lk, lq, Vs + 16 * warp * QLD, KR * QLD, Ds + j0 * QLD, QB * QLD, QLD,
                     DP, lane);
        uint32_t pa[4], dh_[4], dl_[4];
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
            pa[2 * nt + r] = pack_bf16(pf[nt][2 * r], pf[nt][2 * r + 1]);
            dl_pair(pf[nt][2 * r], gw[0], dlt[0], pf[nt][2 * r + 1], gw[1], dlt[1], p.scale,
                    dh_[2 * nt + r], dl_[2 * nt + r]);
          }
#pragma unroll
        for (int nt = 0; nt < NO; nt += 2) {
          if (nt < nto) {
            uint32_t b[4];
            // dv += p^T dA_hi (+ p^T dA_lo)
            v_fragments(b, Ds, QLD, j0, d0 + 8 * nt, lane);
            mma16816(dv[nt], pa, b[0], b[1]);
            mma16816(dv[nt + 1], pa, b[2], b[3]);
            if (PASSES == 3) {
              v_fragments(b, Ds + QB * QLD, QLD, j0, d0 + 8 * nt, lane);
              mma16816(dv[nt], pa, b[0], b[1]);
              mma16816(dv[nt + 1], pa, b[2], b[3]);
            }
            // dk += dl^T q: dl_hi q_hi + dl_hi q_lo + dl_lo q_hi
            v_fragments(b, Qu, QLD, j0, d0 + 8 * nt, lane);
            mma16816(dk[nt], dh_, b[0], b[1]);
            mma16816(dk[nt + 1], dh_, b[2], b[3]);
            if (PASSES == 3) {
              mma16816(dk[nt], dl_, b[0], b[1]);
              mma16816(dk[nt + 1], dl_, b[2], b[3]);
              v_fragments(b, Qu + QB * QLD, QLD, j0, d0 + 8 * nt, lane);
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
          const size_t at = (vid + key) * p.ldg + hc + c;
          p.dk[at] = dk[nt][e];
          p.dv[at] = dv[nt][e];
        }
      }
    }
  }
}

// The backward core: dq (and delta) by the first kernel, then dk and dv.
template <int PASSES>
int attend_bwd(AttnModeBwd a, int B, int H, cudaStream_t st) {
  constexpr int PL = PASSES == 3 ? 2 : 1;
  a.DP = round_up(a.dh, 16);
  const bool narrow = a.DP <= 32;
  static bool ready[4] = {false, false, false, false};
  auto dq = narrow ? attn_mode_dq_kernel<PASSES, 4> : attn_mode_dq_kernel<PASSES, 8>;
  auto dkv = narrow ? attn_mode_dkv_kernel<PASSES, 4> : attn_mode_dkv_kernel<PASSES, 8>;
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
  if (!attn_geometry(a.T, [&](int w, int qb) { return dkv_smem(PL, w, a.DP, qb); }, W, rows))
    return (int)cudaErrorInvalidValue;
  a.KB = rows;
  dkv<<<dim3((a.T + 16 * W - 1) / (16 * W), H, B), 32 * W, dkv_smem(PL, W, a.DP, rows), st>>>(a);
  return (int)cudaGetLastError();
}

// ---- the products and their operands --------------------------------------------

// One projection on tc_gemm_kernel: A (M, K) planes (row stride K) times
// W: (K, N) planes read MN-major (TB 1, row stride ldw: the merged layers'
// and the serving sublayer's Flax-layout weights) or (N, K) planes read
// K-major (TB 0, row stride ldw: torch's layout, the training sublayer's);
// the epilogue EPI (EPI_PLANES: + bias, split to p.oh / p.ol; EPI_RES:
// p.out = p.add + (product + bias); EPI_QKV: both, see tc_gemm.cuh).
template <int PASSES, int EPI, int TB = 1>
int project(const bf16* ah, const bf16* al, int M, int K, const bf16* wh, const bf16* wl,
            int N, int ldw, GemmArgs p, cudaStream_t st) {
  p.M = M;
  p.N = N;
  p.K = K;
  return tc_gemm_ld<PASSES, 0, EPI, TB>(ah, al, M, K, K, wh, wl, TB ? K : N, TB ? N : K, ldw, p, 1,
                                        st);
}

// A plane pair: hi, and lo at `elems` on (null with one pass).
struct Planes {
  bf16 *hi, *lo;
};

template <int PASSES>
Planes carve(bf16*& at, size_t elems) {
  Planes q{at, PASSES == 3 ? at + elems : nullptr};
  at += (PASSES == 3 ? 2 : 1) * elems;
  return q;
}

GemmArgs planes_out(Planes o, const float* bias) {
  GemmArgs g{};
  g.oh = o.hi;
  g.ol = o.lo;
  g.bias = bias;
  return g;
}

GemmArgs res_out(float* out, int ldo, const float* add, const float* bias) {
  GemmArgs g{};
  g.out = out;
  g.ldo = ldo;
  g.add = add;
  g.bias = bias;
  return g;
}

struct Masks {
  const float *mask, *valid;
  int repeat_inc, add_keypad;
};

AttnMode core(Planes q, int ldq, Planes k, Planes v, int ldkv, const Masks& m, Planes o, int D,
              int T, int dh) {
  AttnMode a{};
  a.qh = q.hi;
  a.ql = q.lo;
  a.kh = k.hi;
  a.kl = k.lo;
  a.vh = v.hi;
  a.vl = v.lo;
  a.ldq = ldq;
  a.ldkv = ldkv;
  a.mask = m.mask;
  a.valid = m.valid;
  a.repeat_inc = m.repeat_inc;
  a.add_keypad = m.add_keypad;
  a.oh = o.hi;
  a.ol = o.lo;
  a.ldo = D;
  a.T = T;
  a.dh = dh;
  return a;
}

Planes offset(Planes p, int cols) {
  return Planes{p.hi + cols, p.lo == nullptr ? nullptr : p.lo + cols};
}

}  // namespace
}  // namespace kit
