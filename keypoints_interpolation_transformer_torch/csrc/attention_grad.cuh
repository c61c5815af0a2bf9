// The attention core's backward in one pass (FlashAttention-2's backward,
// deterministic), for the head widths of attention.cuh's exact builds
// (16, 32, 64; tiled_head).  Other head widths keep attention.cuh's two
// passes (attn_bwd_dq_kernel, attn_bwd_dkv_kernel).
//
// Given the forward's q, k, v, its output a and saved (row max m, row sum
// l) of each (video, head, query), and dA = dL/da:
//     delta = sum_d dA a,  S = q k^T,  P = exp(S scale + bias - m) / l,
//     dP = dA v^T,  dS = P (dP - delta),
//     dv = P^T dA,  dk = scale dS^T q,  dq = scale dS k
// One block owns AB_KT keys of one (video, head): their k and v in shared
// memory (d-major for S and dP, key-major for dq), their dk and dv sums in
// registers.  It streams the queries AB_QT at a time (q and dA d-major and
// query-major, delta summed as they are staged) and per tile does the five
// products as register-tiled block products over shared memory: S and dP
// on sgemm.cuh's thread layout (mma_depth, 4 x 4 sums a thread, the
// d-major operands read as float4 of four queries or keys), dv and dk at
// 4 keys x dh / 8 columns a thread, dq at dh / 8 columns a thread.  The
// two passes of attention.cuh did seven products of B H T^2 dh, one query
// or key a thread, every thread reading every row of the other side.
//
// What bounds it on an H100: shared-memory reads.  An SM reads 32 floats a
// cycle and does 128 FFMAs; S and dP read 2 float4 a warp for 16 FFMAs a
// lane and depth, dv and dk 2 for 16, dq 5 for 16 (dh = 32).
//
// The probabilities are rebuilt as the forward built them: the score's FMA
// chain over d runs from 0 in order (softmax_chunk's), its bias is
// key_bias, and the log-sum-exp is kept in its two parts (p = exp(s - m) /
// l: m + log l rounds log l away at a fully blocked row, m = NEG).
//
// dq of a query sums over every key: where one key tile holds all T keys
// (T <= AB_KT; the flagship's T = 128) the block writes it once; else each
// key tile writes its part to scratch and dq_sum_kernel adds the parts in
// order of the tiles.  No sum uses atomics, so dq, dk and dv have the same
// bits from run to run.
#pragma once

#include "attention.cuh"
#include "common.cuh"
#include "sgemm.cuh"

namespace kit {

constexpr int AB_KT = 128;  // keys a block owns
constexpr int AB_QT = 32;   // queries a streamed tile

// The head widths the one-pass core is built for (attention.cuh's exact
// builds).
__host__ __device__ constexpr bool tiled_head(int dh) { return dh == 16 || dh == 32 || dh == 64; }

// Shared memory of the core at head width DH: k and v d-major (DH rows of
// AB_KT), k key-major (AB_KT rows of DH + 4); q and dA d-major (DH rows of
// AB_QT + 4) and query-major (AB_QT rows of DH + 4); P and dS (AB_QT rows
// of AB_KT + 4); the keys' mask and valid values; the queries' m, 1 / l
// and delta.
template <int DH>
struct AbTiles {
  static constexpr int LDH = DH + 4, LDQ = AB_QT + 4, LDP = AB_KT + 4, DG = DH / 8;
  static constexpr int FLOATS = 2 * DH * AB_KT + AB_KT * LDH + 2 * DH * LDQ + 2 * AB_QT * LDH +
                                2 * AB_QT * LDP + 2 * AB_KT + 3 * AB_QT;
  static constexpr int SMEM = FLOATS * (int)sizeof(float);
};

struct AttnGradArgs {
  const float *q, *k, *v;  // at row stride ld, head h at column h * dh
  int ld;
  const float *g, *a;  // dA and the forward's output, at row stride ldg
  int ldg;
  const float* stats;          // (B, H, T, 2)
  const float *mask, *valid;   // (B, T) or null
  int T, H, repeat_inc, add_keypad;
  float scale;
  float* dq;  // at row stride ldq; with more than one key tile, the parts
  int ldq;    // at dq_part (tiles x B T x ldp) and dq unused here
  float *dk, *dv;
  int ldkv;
  float* dq_part;
  int ldp;
};

// n floats (n = 2, 4 or 8) from 16- or 8-byte aligned shared memory.
template <int n>
__device__ __forceinline__ void lds(float (&v)[n], const float* p) {
  if constexpr (n == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int c = 0; c < n; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + c);
      v[c] = t.x;
      v[c + 1] = t.y;
      v[c + 2] = t.z;
      v[c + 3] = t.w;
    }
  }
}

// Grid (ceil(T / AB_KT), H, B).
template <int DH>
__global__ void __launch_bounds__(NT, DH <= 32 ? 2 : 1) attn_grad_kernel(const AttnGradArgs p) {
  using S = AbTiles<DH>;
  using L = Mma<AB_QT, AB_KT>;  // the S and dP tiles: queries x keys
  constexpr int LDH = S::LDH, LDQ = S::LDQ, LDP = S::LDP, DG = S::DG;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                // DH x AB_KT: k, d-major
  float* Vt = Kt + DH * AB_KT;     // DH x AB_KT: v, d-major
  float* Ks = Vt + DH * AB_KT;     // AB_KT x LDH: k, key-major
  float* Qt = Ks + AB_KT * LDH;    // DH x LDQ: q, d-major
  float* Gt = Qt + DH * LDQ;       // DH x LDQ: dA, d-major
  float* Qs = Gt + DH * LDQ;       // AB_QT x LDH: q, query-major
  float* Gs = Qs + AB_QT * LDH;    // AB_QT x LDH: dA, query-major
  float* Ps = Gs + AB_QT * LDH;    // AB_QT x LDP
  float* Ds = Ps + AB_QT * LDP;    // AB_QT x LDP: dS
  float* km = Ds + AB_QT * LDP;    // AB_KT: mask[key]
  float* kv = km + AB_KT;          // AB_KT: valid[key]
  float* qm = kv + AB_KT;          // AB_QT: row max
  float* qil = qm + AB_QT;         // AB_QT: 1 / row sum
  float* qd = qil + AB_QT;         // AB_QT: delta
  const int T = p.T, h = blockIdx.y, b = blockIdx.z, key0 = blockIdx.x * AB_KT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row0 = (size_t)b * T, head = ((size_t)b * p.H + h) * T;
  const int col = h * DH;

  // the key tile: neighbouring threads on neighbouring keys (conflict-free
  // d-major stores)
  for (int idx = threadIdx.x; idx < AB_KT * (DH / 4); idx += NT) {
    const int j = idx % AB_KT, c = 4 * (idx / AB_KT), key = key0 + j;
    float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
    if (key < T) {
      kk = __ldg(reinterpret_cast<const float4*>(p.k + (row0 + key) * p.ld + col + c));
      vv = __ldg(reinterpret_cast<const float4*>(p.v + (row0 + key) * p.ld + col + c));
    }
    *reinterpret_cast<float4*>(Ks + j * LDH + c) = kk;
    Kt[c * AB_KT + j] = kk.x;
    Kt[(c + 1) * AB_KT + j] = kk.y;
    Kt[(c + 2) * AB_KT + j] = kk.z;
    Kt[(c + 3) * AB_KT + j] = kk.w;
    Vt[c * AB_KT + j] = vv.x;
    Vt[(c + 1) * AB_KT + j] = vv.y;
    Vt[(c + 2) * AB_KT + j] = vv.z;
    Vt[(c + 3) * AB_KT + j] = vv.w;
  }
  for (int j = threadIdx.x; j < AB_KT; j += NT) {
    const int key = key0 + j;
    km[j] = (key < T && p.mask != nullptr) ? __ldg(p.mask + row0 + key) : 0.f;
    kv[j] = (key < T && p.valid != nullptr) ? __ldg(p.valid + row0 + key) : 1.f;
  }

  // dk, dv: keys 4 kq + e, columns dc + c
  const int kq = 4 * warp + (lane >> 3), dc = (lane & 7) * DG;
  float dk[4][DG], dv[4][DG];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < DG; ++c) dk[e][c] = dv[e][c] = 0.f;

  for (int q0 = 0; q0 < T; q0 += AB_QT) {
    __syncthreads();  // the last tile is consumed (first: k, v are staged)
    // q and dA of the tile, and delta = dA . a: DH / 4 neighbouring lanes a
    // query, their partial sums added by shuffles in a fixed order
    static_assert(AB_QT * (DH / 4) % 32 == 0 && 32 % (DH / 4) == 0, "whole warps a query");
    for (int idx = threadIdx.x; idx < AB_QT * (DH / 4); idx += NT) {
      const int i = idx / (DH / 4), c = 4 * (idx % (DH / 4)), qi = q0 + i;
      float4 qq = make_float4(0.f, 0.f, 0.f, 0.f), gg = qq, aa = qq;
      if (qi < T) {
        qq = __ldg(reinterpret_cast<const float4*>(p.q + (row0 + qi) * p.ld + col + c));
        gg = __ldg(reinterpret_cast<const float4*>(p.g + (row0 + qi) * p.ldg + col + c));
        aa = __ldg(reinterpret_cast<const float4*>(p.a + (row0 + qi) * p.ldg + col + c));
      }
      *reinterpret_cast<float4*>(Qs + i * LDH + c) = qq;
      *reinterpret_cast<float4*>(Gs + i * LDH + c) = gg;
      Qt[c * LDQ + i] = qq.x;
      Qt[(c + 1) * LDQ + i] = qq.y;
      Qt[(c + 2) * LDQ + i] = qq.z;
      Qt[(c + 3) * LDQ + i] = qq.w;
      Gt[c * LDQ + i] = gg.x;
      Gt[(c + 1) * LDQ + i] = gg.y;
      Gt[(c + 2) * LDQ + i] = gg.z;
      Gt[(c + 3) * LDQ + i] = gg.w;
      float dl = gg.x * aa.x;
      dl = fmaf(gg.y, aa.y, dl);
      dl = fmaf(gg.z, aa.z, dl);
      dl = fmaf(gg.w, aa.w, dl);
#pragma unroll
      for (int o = 1; o < DH / 4; o <<= 1) dl += __shfl_xor_sync(0xffffffffu, dl, o);
      if (c == 0) qd[i] = qi < T ? dl : 0.f;
    }
    for (int i = threadIdx.x; i < AB_QT; i += NT) {
      const int qi = q0 + i;
      const bool in = qi < T;
      qm[i] = in ? __ldg(p.stats + (head + qi) * 2) : 0.f;
      qil[i] = in ? 1.f / __ldg(p.stats + (head + qi) * 2 + 1) : 0.f;
    }
    __syncthreads();

    // S = q k^T and dP = dA v^T over d in order from 0; then P and dS
    {
      const int r0 = L::row(0), c0 = L::col(0);
      float s[4][4], dp[4][4];
      zero(s);
      zero(dp);
      mma_depth<AB_QT, AB_KT, LDQ, DH>(s, Qt + r0, Kt + c0);
      mma_depth<AB_QT, AB_KT, LDQ, DH>(dp, Gt + r0, Vt + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ii = r0 + i, qi = q0 + ii;
        float pv[4], ds[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jj = c0 + j, key = key0 + jj;
          pv[j] = ds[j] = 0.f;
          if (qi < T && key < T) {
            const float sc = fmaf(s[i][j], p.scale,
                                  key_bias(p.repeat_inc, p.add_keypad, qi, key, km[jj], kv[jj]));
            pv[j] = expf(sc - qm[ii]) * qil[ii];
            ds[j] = pv[j] * (dp[i][j] - qd[ii]);
          }
        }
        *reinterpret_cast<float4*>(Ps + ii * LDP + c0) = make_float4(pv[0], pv[1], pv[2], pv[3]);
        *reinterpret_cast<float4*>(Ds + ii * LDP + c0) = make_float4(ds[0], ds[1], ds[2], ds[3]);
      }
    }
    __syncthreads();

    // dv += P^T dA and dk += dS^T q over the tile's queries in order
#pragma unroll 4
    for (int i = 0; i < AB_QT; ++i) {
      const float4 pp = *reinterpret_cast<const float4*>(Ps + i * LDP + 4 * kq);
      const float4 ss = *reinterpret_cast<const float4*>(Ds + i * LDP + 4 * kq);
      float g[DG], x[DG];
      lds<DG>(g, Gs + i * LDH + dc);
      lds<DG>(x, Qs + i * LDH + dc);
      const float pe[4] = {pp.x, pp.y, pp.z, pp.w}, se[4] = {ss.x, ss.y, ss.z, ss.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < DG; ++c) {
          dv[e][c] = fmaf(pe[e], g[c], dv[e][c]);
          dk[e][c] = fmaf(se[e], x[c], dk[e][c]);
        }
    }

    // dq = scale dS k over the tile's keys in order: query t / 8, columns
    // (t % 8) DG + c
    {
      const int i = threadIdx.x >> 3, c0 = (threadIdx.x & 7) * DG, qi = q0 + i;
      float dq[DG];
#pragma unroll
      for (int c = 0; c < DG; ++c) dq[c] = 0.f;
#pragma unroll 2
      for (int j = 0; j < AB_KT; j += 4) {
        const float4 ss = *reinterpret_cast<const float4*>(Ds + i * LDP + j);
        const float se[4] = {ss.x, ss.y, ss.z, ss.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float kr[DG];
          lds<DG>(kr, Ks + (j + jj) * LDH + c0);
#pragma unroll
          for (int c = 0; c < DG; ++c) dq[c] = fmaf(se[jj], kr[c], dq[c]);
        }
      }
      if (qi < T) {
        float* dst = gridDim.x == 1
                         ? p.dq + (row0 + qi) * p.ldq + col + c0
                         : p.dq_part + ((size_t)blockIdx.x * gridDim.z * T + row0 + qi) * p.ldp +
                               col + c0;
#pragma unroll
        for (int c = 0; c < DG; ++c) dst[c] = dq[c] * p.scale;
      }
    }
  }

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int key = key0 + 4 * kq + e;
    if (key >= T) continue;
#pragma unroll
    for (int c = 0; c < DG; ++c) {
      p.dk[(row0 + key) * p.ldkv + col + dc + c] = dk[e][c] * p.scale;
      p.dv[(row0 + key) * p.ldkv + col + dc + c] = dv[e][c];
    }
  }
}

// dq[row * ldq + c] = sum_{z < tiles} part[(z * M + row) * ldp + c] for c
// < n (a multiple of 4), in order of z.
__global__ void dq_sum_kernel(const float* __restrict__ part, int tiles, int M, int ldp, int n,
                              float* __restrict__ dq, int ldq) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x, per = n / 4;
  if (idx >= M * per) return;
  const int row = idx / per, c = 4 * (idx - row * per);
  float4 acc = __ldg(reinterpret_cast<const float4*>(part + (size_t)row * ldp + c));
  for (int z = 1; z < tiles; ++z) {
    const float4 v =
        __ldg(reinterpret_cast<const float4*>(part + ((size_t)z * M + row) * ldp + c));
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  *reinterpret_cast<float4*>(dq + (size_t)row * ldq + c) = acc;
}

// The key tiles of a length: the dq parts the core writes when there are
// more than one.
__host__ __device__ constexpr int key_tiles(int T) { return (T + AB_KT - 1) / AB_KT; }

// The backward of one attention call (AttnArgs as attention.cuh's attn_bwd
// takes it, g = dA at row stride a.ldo) through the one-pass core at head
// width DH: with more than one key tile, dq_part (key_tiles(T) x B T x
// a.ldo floats) is scratch.  Internal linkage: see sgemm_grad.cuh's host
// side.
template <int DH>
static int launch_attn_grad(const AttnArgs& a, const float* g, float* dq, int ldq, float* dk,
                            float* dv, int ldkv, float* dq_part, cudaStream_t st) {
  constexpr int smem = AbTiles<DH>::SMEM;
  static bool ready = false;
  cudaError_t e = allow_smem(attn_grad_kernel<DH>, smem, ready);
  if (e != cudaSuccess) return (int)e;
  const int M = a.B * a.T, tiles = key_tiles(a.T);
  if (M <= 0) return 0;
  const AttnGradArgs p{a.q,   a.k,     a.v,          a.ld,          g,   a.out, a.ldo, a.stats,
                       a.mask, a.valid, a.T,         a.H,           a.repeat_inc, a.add_keypad,
                       1.f / sqrtf((float)DH), dq, ldq, dk,           dv,  ldkv,  dq_part, a.ldo};
  attn_grad_kernel<DH><<<dim3(tiles, a.H, a.B), NT, smem, st>>>(p);
  int rc = (int)cudaGetLastError();
  if (rc || tiles == 1) return rc;
  const int n = a.H * DH;
  dq_sum_kernel<<<(M * (n / 4) + 255) / 256, 256, 0, st>>>(dq_part, tiles, M, a.ldo, n, dq,
                                                          ldq);
  return (int)cudaGetLastError();
}

// The attention backward through the one-pass core where the head width
// has a build (tiled_head), else attention.cuh's two passes (delta (B, H,
// T) their scratch; they need no dq_part).
static inline int attn_grad(const AttnArgs& a, int dh, const float* g, float* dq, int ldq,
                            float* dk, float* dv, int ldkv, float* delta, float* dq_part,
                            cudaStream_t st) {
  switch (dh) {
    case 16: return launch_attn_grad<16>(a, g, dq, ldq, dk, dv, ldkv, dq_part, st);
    case 32: return launch_attn_grad<32>(a, g, dq, ldq, dk, dv, ldkv, dq_part, st);
    case 64: return launch_attn_grad<64>(a, g, dq, ldq, dk, dv, ldkv, dq_part, st);
    default: return attn_bwd(a, dh, g, dq, ldq, dk, dv, ldkv, delta, st);
  }
}

}  // namespace kit
