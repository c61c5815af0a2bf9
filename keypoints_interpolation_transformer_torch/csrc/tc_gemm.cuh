// A product of bf16 planes on the tensor cores in the precision modes
// "high" (bf16x3) and "default" (one bf16 pass): tc_gemm_kernel and its
// launch (tc_gemm, tc_gemm_ld), and the split of a float32 matrix into its
// planes (split_planes).  ffn.cu's split backward runs its four products on
// it, layer_modes.cu the projections of the merged layers in a mode,
// mode_linear.cu the products the JAX package leaves to XLA in a mode,
// attn_sublayer_modes.cu every product of the attention sublayer in a mode;
// see the notes at the top of those files.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"
#include "grad.cuh"
#include "mma_bf16.cuh"

namespace kit {

// ---- the split backward's products ---------------------------------------------
//
// out[m][c] (m < M, c < N) = sum over k of A(m, k) B(c, k) in the mode's
// passes, on 128 x 128 output tiles (the two groups 64 rows each) in
// 64-deep stages.  A is K-major (TA 0: (M, K) planes, 128-row boxes) or
// MN-major (TA 1: (K, M) planes, 64 x 64 boxes); B is MN-major (TB 1: (K,
// N) planes, 64 x 64 boxes) or K-major (TB 0: (N, K) planes, 128-row
// boxes: a weight in torch's layout as a projection reads it).  Split
// blockIdx.z of the contraction covers k in [z krows,
// (z + 1) krows) (krows a multiple of 64, so no box crosses into the next
// split) and writes at out + z * split; an empty split writes zeros.
// Epilogues: the weight-gradient parts (STORE), dx1 = product + add (ADD),
// du = product * gelu'(u) written in float32 and as hi / lo planes, with
// gelu(u)'s planes beside it (the erf of u once for both) and du's column
// sums over the tile's rows (db1's part of row tile blockIdx.y) (DU);
// for the merged layers in a mode, product + bias as hi / lo planes in
// place of the float32 output (PLANES: the q / k / v and cross-attention
// projections, whose outputs only the attention core reads, split) and
// out = add + (product + bias) (RES: an out-projection and its residual);
// for the attention sublayer's training forward, v = product + bias in
// float32 at out and the planes of v, its first scols columns times qs
// (QKV: q, k and v kept for the backward, the core's operands with q's
// scale); for the pointwise chains in a mode (pointwise_modes.cu), out =
// product + bias in float32 (BIAS), and the SwiGLU gate g = (x1 + b1)
// sigmoid(x2 + b2) as hi / lo planes of row stride ldo, from a product
// whose 128-column tile j holds x1's and then x2's columns 64 j .. 64 j +
// 63 (the weight's columns so interleaved; bias = [b1 | b2] as it is,
// ldo = D) (GLU); for mode_linear.cu's weight gradient, the splits' parts
// summed in the same launch (SUM: the splits of an output tile are one
// thread-block cluster (1, 1, splits), splits a power of two up to 8; each
// block leaves its part in shared memory, and after a cluster barrier block
// z adds rows [z 128 / splits, (z + 1) 128 / splits) of every part in rank
// order through distributed shared memory into out; the clusters of the
// first row of tiles also add vrows rows of column parts in a fixed order
// into vout, the bias gradient: 2 splits interleaved row groups a column,
// then the groups in order).
enum { EPI_STORE, EPI_ADD, EPI_DU, EPI_PLANES, EPI_RES, EPI_QKV, EPI_BIAS, EPI_GLU, EPI_SUM };

struct GemmMaps {
  CUtensorMap a[2], b[2];
};

struct GemmArgs {
  int M, N, K, krows;
  float* out;
  int ldo;
  size_t split;
  const float* add;  // EPI_ADD, EPI_RES: (M, N), row stride N
  const float* u;    // EPI_DU: (M, N)
  bf16 *oh, *ol;     // EPI_DU, EPI_PLANES: the output's planes (M, N); ol null with passes 1
  bf16 *gh, *gl;     // EPI_DU: gelu(u)'s planes (M, N); gl null with passes 1
  float* colsum;     // EPI_DU: (row tiles, N) column sums of du
  const float* bias;  // EPI_PLANES (or null), EPI_RES, EPI_QKV, EPI_BIAS: (N); EPI_GLU: [b1 | b2]
  int scols;          // EPI_QKV: the columns scaled by qs before the split
  float qs;
  const float* vpart;    // EPI_SUM: (vrows, N) column parts, or null
  int vrows;
  float* vout;           // EPI_SUM: (N) their sum in row order
};

template <int PASSES>
struct TcGemm {
  static constexpr int PLANES = PASSES == 3 ? 2 : 1;
  static constexpr int STAGE = 2 * TC_TILE * PLANES;  // A's planes, then B's
  static constexpr int STAGES = cmin(MAX_STAGES, TC_SMEM / STAGE);
  static constexpr int SMEM = STAGES * STAGE + 1024;
  static constexpr int LDC = 128 + 8;  // the output tile's row stride in the ring, floats
  static_assert(STAGES >= 3, "a ring of at least three stages");
  static_assert(128 * LDC * 4 <= STAGES * STAGE, "the output tile fits the ring");
};

template <int PASSES, int TA, int EPI, int TB = 1>
__global__ void __launch_bounds__(WG_THREADS, 1)
    tc_gemm_kernel(const __grid_constant__ GemmMaps mp, const GemmArgs p) {
  using G = TcGemm<PASSES>;
  constexpr int STAGES = G::STAGES;
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int warp = warp_index(), lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * 128, n0 = blockIdx.x * 128;
  const int k_begin = blockIdx.z * p.krows, k_end = min(p.K, k_begin + p.krows);
  const int steps = k_end > k_begin ? (k_end - k_begin + 63) / 64 : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int role = warpgroup_index();
  if (role == 2) {  // the producer
    reg_dealloc<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      RingPos at;
      for (int kt = 0; kt < steps; ++kt) {
        const int k0 = k_begin + 64 * kt;
        mbar_wait(&empty[at.stage], at.phase ^ 1);
        unsigned char* sb = ring + at.stage * G::STAGE;
        uint64_t* bar = &full[at.stage];
        mbar_expect_tx(bar, G::STAGE);
        for (int pl = 0; pl < G::PLANES; ++pl) {
          unsigned char* sa = sb + pl * TC_TILE;
          if (TA == 0) {
            tma_load(sa, &mp.a[pl], k0, m0, bar);
          } else {
            tma_load(sa, &mp.a[pl], m0, k0, bar);
            tma_load(sa + TC_TILE / 2, &mp.a[pl], m0 + 64, k0, bar);
          }
          unsigned char* sbb = sb + (G::PLANES + pl) * TC_TILE;
          if (TB == 0) {
            tma_load(sbb, &mp.b[pl], k0, n0, bar);
          } else {
            tma_load(sbb, &mp.b[pl], n0, k0, bar);
            tma_load(sbb + TC_TILE / 2, &mp.b[pl], n0 + 64, k0, bar);
          }
        }
        at.advance<STAGES>();
      }
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  const int wg = role, wq = warp & 3, g = lane >> 2, t = lane & 3;
  // two accumulators, even and odd stages, added at the end: the tensor
  // cores' float32 sums lose precision with the length of a chain (over 32
  // steps of 16 a single chain leaves du about 3x further from its exact
  // value than cuBLAS's float32 product does)
  float acc[64], acc1[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = acc1[e] = 0.f;
  RingPos at;
  int prev = -1;
  auto stage = [&](float(&d)[64]) {
    mbar_wait(&full[at.stage], at.phase);
    const uint32_t sb = smem_u32(ring + at.stage * G::STAGE);
    // the group's 64 rows of A, B's 128 columns (two 64-wide blocks)
    const uint32_t a0 = sb + (TA == 0 ? wg * 64 * 128 : wg * (TC_TILE / 2));
    const uint32_t b0 = sb + G::PLANES * TC_TILE;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t a = a0 + (TA == 0 ? s * 32 : s * 2048), b = b0 + (TB == 0 ? s * 32 : s * 2048);
      auto da = [&](uint32_t x) { return TA == 0 ? desc_k(x) : desc_mn(x, TC_TILE / 2); };
      auto db = [&](uint32_t x) { return TB == 0 ? desc_k(x) : desc_mn(x, TC_TILE / 2); };
      wgmma_ss128<TA, TB>(d, da(a), db(b));
      if (PASSES == 3) {
        wgmma_ss128<TA, TB>(d, da(a), db(b + TC_TILE));
        wgmma_ss128<TA, TB>(d, da(a + TC_TILE), db(b));
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
  for (int kt = 0; kt < steps; kt += 2) {
    stage(acc);
    if (kt + 1 < steps) stage(acc1);
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
  // the tile through shared memory (the ring is free once both groups are
  // done), then whole rows of it: 4 columns a lane, 16-byte accesses
  consumers_sync();
  float* Cs = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(Cs + (64 * wg + 16 * wq + g + 8 * h) * G::LDC + 8 * jj + 2 * t) =
          make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
  consumers_sync();
  float* out = p.out + blockIdx.z * p.split;
  const int c = n0 + 4 * lane;
  const bool in = c < p.N;  // N is a multiple of 16: the lane's 4 columns are in or out
  if constexpr (EPI == EPI_SUM) {
    cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
    const int S = (int)gridDim.z, z = (int)cl.block_rank(), rows = 128 / S;
    cl.sync();  // every part of the tile is in its block's shared memory
    for (int rr = z * rows + warp; rr < (z + 1) * rows && in; rr += CONSUMER_WARPS) {
      const int m = m0 + rr;
      if (m >= p.M) break;
      const int o = rr * G::LDC + 4 * lane;
      float4 sum = *reinterpret_cast<const float4*>(cl.map_shared_rank(Cs, 0) + o);
      for (int r = 1; r < S; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(cl.map_shared_rank(Cs, r) + o);
        sum = make_float4(sum.x + v.x, sum.y + v.y, sum.z + v.z, sum.w + v.w);
      }
      *reinterpret_cast<float4*>(p.out + (size_t)m * p.ldo + c) = sum;
    }
    if (p.vout != nullptr && blockIdx.y == 0) {
      // db: the block's 128 / S columns, each over 2 S interleaved row
      // groups (neighbouring threads on neighbouring columns, eight loads
      // in flight), then the groups in order
      __shared__ float red[32 * CONSUMER_WARPS];
      const int groups = 2 * S, rg = threadIdx.x / rows, col = n0 + z * rows + threadIdx.x % rows;
      float sum = 0.f;
      if (col < p.N) {
        for (int r0 = rg; r0 < p.vrows; r0 += 8 * groups) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int r = r0 + u * groups;
            v[u] = r < p.vrows ? __ldcg(p.vpart + (size_t)r * p.N + col) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) sum += v[u];
        }
      }
      red[threadIdx.x] = sum;
      consumers_sync();
      if ((int)threadIdx.x < rows && col < p.N) {
        float t = red[threadIdx.x];
        for (int q = 1; q < groups; ++q) t += red[q * rows + threadIdx.x];
        p.vout[col] = t;
      }
    }
    cl.sync();  // no block leaves while another reads its part
    return;
  }
  float4 cs = make_float4(0.f, 0.f, 0.f, 0.f);  // EPI_DU: the warp's rows of du, summed
  for (int rr = warp; rr < 128 && in; rr += CONSUMER_WARPS) {
    const int m = m0 + rr;
    if (m >= p.M) break;
    if (EPI == EPI_GLU) {  // two gate columns a lane: x1 at cc, x2 at 64 + cc
      const int cc = 2 * lane, col = 64 * blockIdx.x + cc;
      const float2 x1 = *reinterpret_cast<const float2*>(Cs + rr * G::LDC + cc);
      const float2 x2 = *reinterpret_cast<const float2*>(Cs + rr * G::LDC + 64 + cc);
      const float g0 = (x1.x + __ldg(p.bias + col)) * sigmoidf(x2.x + __ldg(p.bias + p.ldo + col));
      const float g1 =
          (x1.y + __ldg(p.bias + col + 1)) * sigmoidf(x2.y + __ldg(p.bias + p.ldo + col + 1));
      uint32_t h0, l0;
      split2(g0, g1, h0, l0);
      const size_t go = (size_t)m * p.ldo + col;
      *reinterpret_cast<uint32_t*>(p.oh + go) = h0;
      if (PASSES == 3) *reinterpret_cast<uint32_t*>(p.ol + go) = l0;
      continue;
    }
    float4 v = *reinterpret_cast<const float4*>(Cs + rr * G::LDC + 4 * lane);
    const size_t o = (size_t)m * p.N + c;
    if (EPI == EPI_DU) {
      const float4 uu = __ldg(reinterpret_cast<const float4*>(p.u + o));
      v = make_float4(v.x * gelu_grad(uu.x), v.y * gelu_grad(uu.y), v.z * gelu_grad(uu.z),
                      v.w * gelu_grad(uu.w));
      cs = make_float4(cs.x + v.x, cs.y + v.y, cs.z + v.z, cs.w + v.w);
      uint32_t h0, l0, h1, l1;
      split2(v.x, v.y, h0, l0);
      split2(v.z, v.w, h1, l1);
      *reinterpret_cast<uint2*>(p.oh + o) = make_uint2(h0, h1);
      if (PASSES == 3) *reinterpret_cast<uint2*>(p.ol + o) = make_uint2(l0, l1);
      split2(gelu(uu.x), gelu(uu.y), h0, l0);
      split2(gelu(uu.z), gelu(uu.w), h1, l1);
      *reinterpret_cast<uint2*>(p.gh + o) = make_uint2(h0, h1);
      if (PASSES == 3) *reinterpret_cast<uint2*>(p.gl + o) = make_uint2(l0, l1);
    }
    if (EPI == EPI_ADD) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p.add + o));
      v = make_float4(v.x + a.x, v.y + a.y, v.z + a.z, v.w + a.w);
    }
    if ((EPI == EPI_PLANES && p.bias != nullptr) || EPI == EPI_RES || EPI == EPI_QKV ||
        EPI == EPI_BIAS) {
      const float4 b = __ldg(reinterpret_cast<const float4*>(p.bias + c));
      v = make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
    }
    if (EPI == EPI_QKV) {  // c is a multiple of 4, as scols is
      *reinterpret_cast<float4*>(out + (size_t)m * p.ldo + c) = v;
      if (c < p.scols)
        v = make_float4(__fmul_rn(v.x, p.qs), __fmul_rn(v.y, p.qs), __fmul_rn(v.z, p.qs),
                        __fmul_rn(v.w, p.qs));
    }
    if (EPI == EPI_PLANES || EPI == EPI_QKV) {
      uint32_t h0, l0, h1, l1;
      split2(v.x, v.y, h0, l0);
      split2(v.z, v.w, h1, l1);
      *reinterpret_cast<uint2*>(p.oh + o) = make_uint2(h0, h1);
      if (PASSES == 3) *reinterpret_cast<uint2*>(p.ol + o) = make_uint2(l0, l1);
      continue;
    }
    if (EPI == EPI_RES) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p.add + o));
      v = make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
    }
    *reinterpret_cast<float4*>(out + (size_t)m * p.ldo + c) = v;
  }
  if (EPI == EPI_DU) {  // the 8 warps' sums added in order: du's column sums of the tile
    consumers_sync();    // every warp is done with Cs
    float4* red = reinterpret_cast<float4*>(Cs);
    red[warp * 32 + lane] = cs;
    consumers_sync();
    if (warp == 0 && in) {
      float4 t = red[lane];
      for (int w = 1; w < CONSUMER_WARPS; ++w) {
        const float4 x = red[w * 32 + lane];
        t = make_float4(t.x + x.x, t.y + x.y, t.z + x.z, t.w + x.w);
      }
      *reinterpret_cast<float4*>(p.colsum + (size_t)blockIdx.y * p.N + c) = t;
    }
  }
}

// One product: A's and B's maps from their planes (hi, and lo with passes
// 3): A (a_rows, a_cols, row stride lda) read K-major (TA 0, 128-row boxes)
// or MN-major (TA 1, 64-row boxes), B (b_rows, b_cols, row stride ldb)
// MN-major (TB 1, 64-row boxes) or K-major (TB 0, 128-row boxes); the grid
// from the output (M, N) and the splits.
// Internal linkage: see sgemm_grad.cuh's host side.
template <int PASSES, int TA, int EPI, int TB = 1>
static int tc_gemm_ld(const bf16* ah, const bf16* al, int a_rows, int a_cols, int lda,
                      const bf16* bh, const bf16* bl, int b_rows, int b_cols, int ldb, GemmArgs p,
                      int splits, cudaStream_t st) {
  using G = TcGemm<PASSES>;
  static bool ready = false;
  cudaError_t e = allow_smem(tc_gemm_kernel<PASSES, TA, EPI, TB>, G::SMEM, ready);
  if (e != cudaSuccess) return (int)e;
  GemmMaps mp;
  const int a_box = TA == 0 ? 128 : 64, b_box = TB == 0 ? 128 : 64;
  int rc;
  if ((rc = plane_map(&mp.a[0], ah, a_rows, a_cols, a_box, lda)) ||
      (rc = plane_map(&mp.a[1], PASSES == 3 ? al : nullptr, a_rows, a_cols, a_box, lda)) ||
      (rc = plane_map(&mp.b[0], bh, b_rows, b_cols, b_box, ldb)) ||
      (rc = plane_map(&mp.b[1], PASSES == 3 ? bl : nullptr, b_rows, b_cols, b_box, ldb)))
    return rc;
  p.krows = round_up((p.K + splits - 1) / splits, 64);
  const dim3 grid((p.N + 127) / 128, (p.M + 127) / 128, splits);
  if constexpr (EPI == EPI_SUM) {  // the splits of a tile: one cluster
    if (splits > 8 || (splits & (splits - 1))) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(WG_THREADS);
    cfg.dynamicSmemBytes = G::SMEM;
    cfg.stream = st;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 1;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = splits;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, tc_gemm_kernel<PASSES, TA, EPI, TB>, mp, p);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  }
  tc_gemm_kernel<PASSES, TA, EPI, TB><<<grid, WG_THREADS, G::SMEM, st>>>(mp, p);
  return (int)cudaGetLastError();
}

// tc_gemm_ld with A and B each as wide as its row stride.
template <int PASSES, int TA, int EPI>
static int tc_gemm(const bf16* ah, const bf16* al, int a_rows, int a_cols, const bf16* bh,
                   const bf16* bl, int b_rows, int b_cols, GemmArgs p, int splits,
                   cudaStream_t st) {
  return tc_gemm_ld<PASSES, TA, EPI>(ah, al, a_rows, a_cols, a_cols, bh, bl, b_rows, b_cols,
                                     b_cols, p, splits, st);
}

// hi / lo planes of x (n values, a multiple of 4); lo null: hi only.
__global__ void split_kernel(const float* __restrict__ x, size_t n, bf16* __restrict__ hi,
                             bf16* __restrict__ lo) {
  for (size_t i = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x); i < n;
       i += 4 * (size_t)gridDim.x * blockDim.x) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(x + i));
    uint32_t h0, l0, h1, l1;
    split2(v.x, v.y, h0, l0);
    split2(v.z, v.w, h1, l1);
    *reinterpret_cast<uint2*>(hi + i) = make_uint2(h0, h1);
    if (lo != nullptr) *reinterpret_cast<uint2*>(lo + i) = make_uint2(l0, l1);
  }
}

// x (M, F) float32 -> hi / lo planes of row stride FP (F <= FP, both
// multiples of 4), zero in the columns F .. FP - 1; lo null: hi only: the
// planes of a matrix whose width is no multiple of 8 (TMA's 16-byte row
// rule), as the pointwise chains' 108-wide frames and mode_linear.cu's
// operands are.
__global__ void __launch_bounds__(NT) split_rows_kernel(const float* __restrict__ x, int M, int F,
                                                        int FP, bf16* __restrict__ hi,
                                                        bf16* __restrict__ lo) {
  const int per_row = FP / 4;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < (size_t)M * per_row;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / per_row;
    const int c = 4 * (int)(i - row * per_row);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < F) v = __ldg(reinterpret_cast<const float4*>(x + row * F + c));
    uint32_t h0, l0, h1, l1;
    split2(v.x, v.y, h0, l0);
    split2(v.z, v.w, h1, l1);
    const size_t o = row * FP + c;
    *reinterpret_cast<uint2*>(hi + o) = make_uint2(h0, h1);
    if (lo != nullptr) *reinterpret_cast<uint2*>(lo + o) = make_uint2(l0, l1);
  }
}

inline int split_rows(const float* x, int M, int F, int FP, bf16* hi, bf16* lo,
                      cudaStream_t st) {
  const int blocks = (int)std::min<size_t>(((size_t)M * FP / 4 + NT - 1) / NT, 8 * 132);
  split_rows_kernel<<<blocks, NT, 0, st>>>(x, M, F, FP, hi, lo);
  return (int)cudaGetLastError();
}

inline int split_planes(const float* x, size_t n, bf16* hi, bf16* lo, cudaStream_t st) {
  const int blocks = (int)std::min<size_t>((n / 4 + NT - 1) / NT, 8 * 132);
  split_kernel<<<blocks, NT, 0, st>>>(x, n, hi, lo);
  return (int)cudaGetLastError();
}

}  // namespace kit
