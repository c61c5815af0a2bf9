// The per-op attention forward on register tiles, for the head widths of
// attention.cuh's exact builds (16, 32, 64; tiled_head); other head widths
// keep attn_fwd_kernel (one query a thread).
//
//     out = softmax(q k^T scale + bias) v,   stats = (row max m, row sum l)
//
// One block of NT = 256 threads owns AF_QT = 64 queries of one (video,
// head): warp w the 8 rows 8w .. 8w + 7, so every row of the scores lives in
// one warp and its max and sum are warp shuffles, with no barrier.  The
// queries stay in shared memory; keys and values stream through a ring of
// two slots of AF_KT = 128 rows (one slot where T <= 128) by cp.async
// 16-byte copies, each tile's keys and values in commit groups of their
// own, so the scores of tile t run while its values land and tile t + 1 is
// in flight.  Per key tile:
//   * S = q k^T as a register-tiled product: lane l holds the scores of
//     its warp's 8 rows and the keys l, l + 32, l + 64, l + 96 (8 x 4 sums);
//     a step of 4 depths reads 8 float4 of q (the same for every lane) and
//     4 float4 of k (rows of stride dh + 4: a quarter-warp's 8 rows fall on
//     32 distinct banks) for 128 FFMAs, where attn_fwd_kernel read 1 float4
//     for 4;
//   * the online softmax: the tile's row max by 5 xor shuffles, the running
//     max, sum and output rescaled to it, p = exp(s - m) into a row-major P
//     tile (each warp's own rows, so a __syncwarp would do; the block's
//     barrier for the values comes first);
//   * O += P V as a second register-tiled product: the lanes of a warp are
//     dh / 4 column groups (4 columns each) times 128 / dh key groups, and
//     lane (c, g) sums its 8 rows x 4 columns over the keys of chunks g,
//     g + 128 / dh, ... of 4 (8 float4 of P and 4 of v for 128 FFMAs).
// At the end each row's sum is added over the warp and the key groups'
// partial outputs by xor shuffles, in a fixed order (the same bits from run
// to run), then out = o / l and, where asked, stats (B, H, T, 2) = (m, l):
// the log-sum-exp in two parts, since m + log l rounds log l away at a
// fully blocked row (m = NEG).
//
// The score is the backward's (attention_grad.cuh rebuilds p = exp(s scale
// + bias - m) / l from it): the FMA chain over d = 0, 1, ... in order from
// a sum of 0, then fmaf(s, scale, key_bias(...)); keys at or past T count
// as -inf.
//
// What bounds it on an H100: float32 FFMA work, 4 B H T^2 dh FLOP (2 in S,
// 2 in P V) against 4 (B, T, D) tensors of traffic; at dh = 32 the products
// read 12 float4 a warp for 128 FFMAs a lane (48 shared-memory wavefronts
// for 32 FFMA cycles), and the softmax adds the bias, an exp and a share
// of the shuffles to each score.
#pragma once

#include "attention.cuh"
#include "common.cuh"
#include "sgemm.cuh"

namespace kit {

constexpr int AF_QT = 64;   // queries a block owns: 8 rows a warp
constexpr int AF_KT = 128;  // keys a streamed tile: 4 a lane

// Shared memory of the forward at head width DH: the query tile and the P
// tile, then the ring's slots (k and v rows of stride DH + 4, the keys'
// mask and valid values).
template <int DH>
struct AfTiles {
  static constexpr int LDH = DH + 4, LDP = AF_KT + 4;
  static constexpr int CG = DH / 4;   // column groups of the P V product
  static constexpr int KG = 32 / CG;  // key groups of the P V product
  static constexpr int SLOT = 2 * AF_KT * LDH + 2 * AF_KT;
  static constexpr int FIXED = AF_QT * LDH + AF_QT * LDP;
  __host__ __device__ static constexpr int bytes(int slots) {
    return (FIXED + slots * SLOT) * (int)sizeof(float);
  }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

// Grid (ceil(T / AF_QT), H, B); dynamic shared memory AfTiles<DH>::bytes(1
// where T <= AF_KT, else 2).  q, k, v at row stride a.ld, out at a.ldo
// (multiples of 4, 16-byte aligned), head h at column h * DH.
template <int DH>
__global__ void __launch_bounds__(NT, DH <= 32 ? 2 : 1)
    attn_fwd_tiled_kernel(const AttnArgs a, const float scale) {
  using S = AfTiles<DH>;
  constexpr int LDH = S::LDH, LDP = S::LDP, CG = S::CG, KG = S::KG, RW = AF_QT / 8;
  static_assert(DH % 4 == 0 && 32 % CG == 0 && (AF_KT / 4) % KG == 0, "whole groups");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // AF_QT x LDH
  float* Ps = Qs + AF_QT * LDH;    // AF_QT x LDP
  float* ring = Ps + AF_QT * LDP;  // slots of S::SLOT
  const int T = a.T, h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * AF_QT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row0 = (size_t)b * T;
  const int col = h * DH, tiles = (T + AF_KT - 1) / AF_KT;

  // key tile t into slot t % 2: its k rows with the keys' mask and valid
  // values (one group), or its v rows (another); rows past T as 0
  auto stage = [&](int t, bool values) {
    if (t >= tiles) return;
    float* slot = ring + (t & 1) * S::SLOT;
    const int k0 = t * AF_KT;
    const float* src = values ? a.v : a.k;
    float* dst = slot + (values ? AF_KT * LDH : 0);
    for (int idx = threadIdx.x; idx < AF_KT * CG; idx += NT) {
      const int j = idx / CG, c = 4 * (idx % CG), key = k0 + j;
      const bool ok = key < T;
      cp_async16(dst + j * LDH + c, ok ? src + (row0 + key) * a.ld + col + c : src, ok);
    }
    if (values) return;
    static_assert(2 * AF_KT == NT, "one mask or valid value a thread");
    const bool is_valid = threadIdx.x >= AF_KT;
    const int j = threadIdx.x - (is_valid ? AF_KT : 0), key = k0 + j;
    const float* vec = is_valid ? a.valid : a.mask;
    float* to = slot + 2 * AF_KT * LDH + threadIdx.x;
    if (vec == nullptr)
      *to = is_valid ? 1.f : 0.f;
    else
      cp_async4(to, key < T ? vec + row0 + key : vec, key < T);
  };

  for (int idx = threadIdx.x; idx < AF_QT * CG; idx += NT) {
    const int r = idx / CG, c = 4 * (idx % CG), qi = q0 + r;
    const bool ok = qi < T;
    cp_async16(Qs + r * LDH + c, ok ? a.q + (row0 + qi) * a.ld + col + c : a.q, ok);
  }
  // four groups in flight: q with k of tile 0, v of tile 0, k and v of tile
  // 1 (empty where there is none); each tile then commits two more
  stage(0, false);
  cp_async_commit();
  stage(0, true);
  cp_async_commit();
  stage(1, false);
  cp_async_commit();
  stage(1, true);
  cp_async_commit();

  const int r0 = warp * RW, c4 = 4 * (lane % CG), grp = lane / CG;
  float o[RW][4], m[RW], l[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  }

  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * AF_KT;
    const float* Ks = ring + (t & 1) * S::SLOT;
    const float* Vs = Ks + AF_KT * LDH;
    const float* km = Vs + AF_KT * LDH;
    const float* kv = km + AF_KT;
    cp_async_wait<3>();  // k of tile t (and q) have landed: this thread's copies
    __syncthreads();     // ... and every thread's

    // S = q k^T over d in order from 0
    float s[RW][4];
    zero(s);
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
      float4 kk[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        kk[u] = *reinterpret_cast<const float4*>(Ks + (lane + 32 * u) * LDH + d);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(Qs + (r0 + i) * LDH + d);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          s[i][u] = fmaf(qq.x, kk[u].x, s[i][u]);
          s[i][u] = fmaf(qq.y, kk[u].y, s[i][u]);
          s[i][u] = fmaf(qq.z, kk[u].z, s[i][u]);
          s[i][u] = fmaf(qq.w, kk[u].w, s[i][u]);
        }
      }
    }
    // scale and bias; the online softmax, one warp a row
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = lane + 32 * u, key = k0 + j;
      const float kmj = km[j], kvj = kv[j];
#pragma unroll
      for (int i = 0; i < RW; ++i)
        s[i][u] = key < T ? fmaf(s[i][u], scale,
                                 key_bias(a.repeat_inc, a.add_keypad, q0 + r0 + i, key, kmj, kvj))
                          : -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // tile 0 holds key 0 < T, so m is finite from then on: no -inf - -inf
      const float mnew = fmaxf(m[i], mx);
      const float corr = expf(m[i] - mnew);
      m[i] = mnew;
      l[i] *= corr;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] *= corr;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float p = expf(s[i][u] - mnew);
        l[i] += p;
        Ps[(r0 + i) * LDP + lane + 32 * u] = p;
      }
    }
    cp_async_wait<2>();  // v of tile t has landed
    __syncthreads();     // ... for every thread, and P is written

    // O += P V over this lane's key group, its chunks of 4 keys in order
#pragma unroll 4
    for (int ch = grp; ch < AF_KT / 4; ch += KG) {
      float4 vv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        vv[e] = *reinterpret_cast<const float4*>(Vs + (4 * ch + e) * LDH + c4);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 pp = *reinterpret_cast<const float4*>(Ps + (r0 + i) * LDP + 4 * ch);
        const float pe[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[i][0] = fmaf(pe[e], vv[e].x, o[i][0]);
          o[i][1] = fmaf(pe[e], vv[e].y, o[i][1]);
          o[i][2] = fmaf(pe[e], vv[e].z, o[i][2]);
          o[i][3] = fmaf(pe[e], vv[e].w, o[i][3]);
        }
      }
    }
    // the slot of tile t is free once every warp is done with it
    if (t + 2 < tiles) __syncthreads();
    stage(t + 2, false);
    cp_async_commit();
    stage(t + 2, true);
    cp_async_commit();
  }

  // each row's sum over the warp, its output over the key groups
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    l[i] = warp_sum(l[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int off = CG; off < 32; off <<= 1)
        o[i][e] += __shfl_xor_sync(0xffffffffu, o[i][e], off);
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= T) continue;
    if (i % KG == grp) {
      const float inv = 1.f / l[i];
      *reinterpret_cast<float4*>(a.out + (row0 + qi) * a.ldo + col + c4) =
          make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv);
    }
    if (a.stats != nullptr && lane == i)
      *reinterpret_cast<float2*>(a.stats + (((size_t)b * a.H + h) * T + qi) * 2) =
          make_float2(m[i], l[i]);
  }
}

// Internal linkage: see sgemm_grad.cuh's host side.
template <int DH>
static int launch_attn_fwd_tiled(const AttnArgs& a, cudaStream_t st) {
  using S = AfTiles<DH>;
  static bool ready = false;
  cudaError_t e = allow_smem(attn_fwd_tiled_kernel<DH>, S::bytes(2), ready);
  if (e != cudaSuccess) return (int)e;
  if (a.B <= 0 || a.T <= 0) return 0;
  const dim3 grid((a.T + AF_QT - 1) / AF_QT, a.H, a.B);
  attn_fwd_tiled_kernel<DH><<<grid, NT, S::bytes(a.T > AF_KT ? 2 : 1), st>>>(
      a, 1.f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

// The per-op forward: the register-tiled core where the head width has a
// build (tiled_head), else attention.cuh's attn_fwd_kernel; both write
// a.stats where it is not null.
static inline int attention_forward(const AttnArgs& a, int dh, cudaStream_t st) {
  switch (dh) {
    case 16: return launch_attn_fwd_tiled<16>(a, st);
    case 32: return launch_attn_fwd_tiled<32>(a, st);
    case 64: return launch_attn_fwd_tiled<64>(a, st);
    default: return attn_fwd(a, dh, st);
  }
}

}  // namespace kit
