// The products of the training backward kernels (ffn.cu, attn_sublayer.cu)
// on sgemm.cuh's float32 core: a BM x N tile of sums a block, 8 x 8 (or
// RT x 8) of them a thread, one DEPTH-deep step at a time (mma_depth).
//
// In most of them neither operand sits whole in shared memory: a backward
// product reduces over a whole row (K = FF for dx1 = du W1^T) or over all
// the token rows (the weight gradients), so both operands stream through a
// ring of grad_stages(N) tiles of SD = 32 depths, cp.async 16-byte copies
// (L2 only): tile s + stages - 1 is in flight while tile s is multiplied,
// one barrier a step.  The A tile lands as it lies in device memory and a
// "prep" pass, run one step ahead for the next tile, writes it k-major
// into one of two tiles the FMAs read:
//   * a row-major A (rows m, depth k at a[m * lda + k]: the activation of
//     dx = dr + dqkv W_in, da = dr W_out^T, dx1 = du W1^T + dz) lands
//     [r][kk] and is transposed;
//   * a k-major A (a[k * lda + m]: the weight gradients dW = A^T B over
//     token rows k) lands [kk][r] and is copied, through the exact-erf GELU
//     where the product asks (dW2^T = dz^T gelu(u), with m over FF so that
//     each u is taken through the GELU once).
// The prep pass costs 8 floats a thread a step against 2048 FFMAs, and
// needs no barrier of its own: tile s + 1 has landed at the barrier of
// step s, and the FMAs read it after the barrier of step s + 1.  It also
// sums a k-major A's columns on the way (the bias gradients: db1 = sum du,
// db_in = sum dqkv, db_out = sum dr), so no pass reads those again.
// Where A is one D-wide row tile (du = (dz W2^T) gelu'(u), K = D) it stays
// in shared memory instead, and the block walks every column tile of W
// through sgemm.cuh's chained ring (nnr_kernel), as the merged layers'
// projections do.
//
// Weight gradients reduce over N = B * T rows, so a product is split over
// row ranges (grid z) into partial sums, as many as fill one wave of the
// card with the output tiles, added in a fixed order by sum_split (no
// atomics: the same bits from run to run).  One launch computes up to
// three such products side by side (their row tiles in grid x), e.g.
// [dW1^T | dW2^T] or [dW_in^T | dW_out^T].
#pragma once

#include "common.cuh"
#include "grad.cuh"
#include "sgemm.cuh"

namespace kit {

constexpr int SD = 32;  // depths of a streamed tile

// Streamed tiles in the ring of an N-wide product: 4, or 3 above N = 384
// (shared memory).
__host__ __device__ constexpr int grad_stages(int N) { return N <= 384 ? 4 : 3; }

// Shared memory of a streamed BM x N product (A row-major or k-major as it
// lands): the ring of A and B tiles, then the two k-major A tiles.
template <int BM, int N, bool A_ROWS>
struct Stream {
  static constexpr int STAGES = grad_stages(N);
  static constexpr int LDA = BM + 4;  // k-major A: 16-byte rows, 4 LDA = 16 mod 32
  static constexpr int LDL = SD + 4;  // a row-major A row as it lands
  static constexpr int A_LAND = A_ROWS ? BM * LDL : SD * BM;
  static constexpr int B_TILE = SD * N;
  static constexpr int FLOATS = STAGES * (A_LAND + B_TILE) + 2 * SD * LDA;
  static constexpr int SMEM = FLOATS * (int)sizeof(float);
  static_assert(STAGES >= 3, "the prep pass reads tile s + 1 during step s");
};

// The A operand of a streamed product: element (m, k) at p[m * ld + k]
// (row-major) or p[k * ld + m] (k-major); m < rows, a multiple of 4, as
// are ld and, for a row-major A, the depth K.
struct Opnd {
  const float* p;
  int ld, rows;
};

// acc += sum_{k0 <= k < k1} A(m0 + row(i), k) B[k * ldb + n0 + col(j)],
// columns >= ncols (a multiple of 4) of B read as 0, A through the GELU
// when gelu (k-major only).  A k-major A also adds, into csum, its columns
// m0 + c .. m0 + c + 3 (c = 4 (thread % (BM / 4))) over this thread's
// share of the rows, before the GELU.  smem: Stream<BM, N, A_ROWS>::FLOATS
// floats.  Starts with the ring free and ends with a barrier and no copy
// in flight.
template <int BM, int N, bool A_ROWS>
__device__ __forceinline__ void stream_mma(float (&acc)[BM / 8][N / 32], float* smem,
                                           const Opnd& a, int m0, const float* __restrict__ B,
                                           int ldb, int n0, int ncols, int k0, int k1,
                                           bool gelu_a, float4& csum) {
  using S = Stream<BM, N, A_ROWS>;
  using L = Mma<BM, N>;
  constexpr int STAGES = S::STAGES;
  static_assert(A_ROWS || NT % (BM / 4) == 0, "one column group a thread");
  float* land_a = smem;
  float* land_b = land_a + STAGES * S::A_LAND;
  float* at = land_b + STAGES * S::B_TILE;
  const int steps = k1 > k0 ? (k1 - k0 + SD - 1) / SD : 0;
  // tile s into ring slot s % STAGES (nothing past the last tile)
  auto fetch = [&](int s) {
    if (s >= steps) return;
    const int kb = k0 + s * SD;
    float* da = land_a + (s % STAGES) * S::A_LAND;
    if constexpr (A_ROWS) {
      for (int idx = threadIdx.x; idx < BM * (SD / 4); idx += NT) {
        const int r = idx / (SD / 4), c = 4 * (idx % (SD / 4));
        const bool ok = m0 + r < a.rows && kb + c < k1;
        cp_async16(da + r * S::LDL + c, ok ? a.p + (size_t)(m0 + r) * a.ld + kb + c : a.p, ok);
      }
    } else {
      for (int idx = threadIdx.x; idx < SD * (BM / 4); idx += NT) {
        const int kk = idx / (BM / 4), c = 4 * (idx % (BM / 4));
        const bool ok = kb + kk < k1 && m0 + c < a.rows;
        cp_async16(da + kk * BM + c, ok ? a.p + (size_t)(kb + kk) * a.ld + m0 + c : a.p, ok);
      }
    }
    float* db = land_b + (s % STAGES) * S::B_TILE;
    static_assert(SD * N / 4 % NT == 0, "whole float4 copies a thread");
#pragma unroll
    for (int u = 0; u < SD * N / 4 / NT; ++u) {
      const int idx = threadIdx.x + u * NT, kk = idx / (N / 4), c = 4 * (idx % (N / 4));
      const bool ok = kb + kk < k1 && n0 + c < ncols;
      cp_async16(db + kk * N + c, ok ? B + (size_t)(kb + kk) * ldb + n0 + c : B, ok);
    }
  };
  // the landed A tile s, k-major, into at[s & 1]
  auto prep = [&](int s) {
    if (s >= steps) return;
    const float* src = land_a + (s % STAGES) * S::A_LAND;
    float* dst = at + (s & 1) * SD * S::LDA;
    if constexpr (A_ROWS) {
      for (int idx = threadIdx.x; idx < BM * (SD / 4); idx += NT) {
        const int r = idx % BM, c = 4 * (idx / BM);
        const float4 v = *reinterpret_cast<const float4*>(src + r * S::LDL + c);
        dst[c * S::LDA + r] = v.x;
        dst[(c + 1) * S::LDA + r] = v.y;
        dst[(c + 2) * S::LDA + r] = v.z;
        dst[(c + 3) * S::LDA + r] = v.w;
      }
    } else {
      for (int idx = threadIdx.x; idx < SD * (BM / 4); idx += NT) {
        const int kk = idx / (BM / 4), c = 4 * (idx % (BM / 4));
        float4 v = *reinterpret_cast<const float4*>(src + kk * BM + c);
        csum.x += v.x;
        csum.y += v.y;
        csum.z += v.z;
        csum.w += v.w;
        if (gelu_a) v = make_float4(gelu(v.x), gelu(v.y), gelu(v.z), gelu(v.w));
        *reinterpret_cast<float4*>(dst + kk * S::LDA + c) = v;
      }
    }
  };
  const int r0 = L::row(0), c0 = L::col(0);
  for (int q = 0; q < STAGES - 1; ++q) {
    fetch(q);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();  // tile 0 has landed (this thread's copies)
  __syncthreads();              // ... and every thread's
  prep(0);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 3>();  // tile s + 1 has landed (this thread's copies)
    __syncthreads();  // ... and every thread's; prep(s) is written; step s - 1 is done
    fetch(s + STAGES - 1);  // into the slot of tile s - 1
    cp_async_commit();
    prep(s + 1);  // into the k-major tile step s - 1 read
    mma_depth<BM, N, S::LDA, SD>(acc, at + (s & 1) * SD * S::LDA + r0,
                                 land_b + (s % STAGES) * S::B_TILE + c0);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// out (M x ncols) = A W, A (M x K) row-major at row stride lda, W (K x
// ncols) row-major at ldw, then * gelu'(u) where u is not null (nnr_kernel
// only) and + add where add is not null (each (M x ncols) at its own row
// stride).
struct NNArgs {
  const float* a;
  int lda, M, K;
  const float* w;
  int ldw, ncols;
  float* out;
  int ldo;
  const float* add;
  int ldadd;
  const float* u;
  int ldu;
};

// The sums of rows m0 .. and columns n0 .. of an NNArgs product to
// p.out, plus p.add where it is not null.
template <int BM, int N>
__device__ __forceinline__ void nn_store(const NNArgs& p, int m0, int n0,
                                         const float (&acc)[BM / 8][N / 32]) {
  using L = Mma<BM, N>;
#pragma unroll
  for (int i = 0; i < L::RT; ++i) {
    const int row = m0 + L::row(i);
    if (row >= p.M) continue;
#pragma unroll
    for (int h = 0; h < L::CT / 4; ++h) {
      const int col = n0 + L::col(4 * h);
      if (col >= p.ncols) continue;
      float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                             acc[i][4 * h + 3]);
      if (p.add != nullptr) {
        const float4 d =
            __ldg(reinterpret_cast<const float4*>(p.add + (size_t)row * p.ldadd + col));
        v = make_float4(v.x + d.x, v.y + d.y, v.z + d.z, v.w + d.w);
      }
      *reinterpret_cast<float4*>(p.out + (size_t)row * p.ldo + col) = v;
    }
  }
}

// Grid (ceil(M / BM), ceil(ncols / N)).
template <int BM, int N>
__global__ void __launch_bounds__(NT, 1) nn_kernel(const NNArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * N;
  float acc[BM / 8][N / 32];
  float4 unused = make_float4(0.f, 0.f, 0.f, 0.f);
  zero(acc);
  stream_mma<BM, N, true>(acc, smem, Opnd{p.a, p.lda, p.M}, m0, p.w, p.ldw, n0, p.ncols, 0,
                          p.K, false, unused);
  nn_store<BM, N>(p, m0, n0, acc);
}

// The row tile of nnr_kernel at K = D: 64 rows, 32 at D = 512 (shared
// memory).
__host__ __device__ constexpr int resident_rows(int D) { return D <= 384 ? 64 : 32; }

// The shared memory of nnr_kernel at K = D: the BM-row A tile k-major,
// sgemm.cuh's ring of 16-deep W tiles, and the epilogue's u tile.
template <int BM, int N, int D>
struct Resident {
  static constexpr int LDA = BM + 4, STAGES = 3, DEPTH = BK;
  static constexpr int FLOATS = D * LDA + STAGES * DEPTH * N + BM * N;
  static constexpr int SMEM = FLOATS * (int)sizeof(float);
};

// An NNArgs product with K = D: the block's BM rows of A stay in shared
// memory and every column tile of W streams through the chained ring, the
// tile of u its epilogue reads (where u is not null) landing by cp.async
// during the product's first steps; csum, when not null, receives the
// block's column sums of A (csum + blockIdx.x * D, sums over its rows in
// order).  Grid ceil(M / BM).
template <int BM, int N, int D>
__global__ void __launch_bounds__(NT, 1) nnr_kernel(const NNArgs p, float* csum) {
  using R = Resident<BM, N, D>;
  using L = Mma<BM, N>;
  using WRing = Ring<N, R::DEPTH, R::STAGES>;
  extern __shared__ __align__(16) float smem[];
  float* AT = smem;
  WRing ring{smem + D * R::LDA, 0};
  float* U = ring.buf + R::STAGES * R::DEPTH * N;  // BM x N
  const int m0 = blockIdx.x * BM, tiles = (p.ncols + N - 1) / N;
  const float* u = p.u;
  auto w = [&](int c) {
    return c < tiles ? Wt{p.w + c * N, p.ldw, min(N, p.ncols - c * N), D} : Wt{};
  };
  ring.start(w(0), w(1));  // in flight while A stages
  stage_kmajor<BM, R::LDA>(AT, p.a, p.lda, m0, p.M, D);
  __syncthreads();
  if (csum != nullptr)
    for (int c = threadIdx.x; c < D; c += NT) {
      float v = 0.f;
      for (int r = 0; r < BM; ++r) v += AT[c * R::LDA + r];
      csum[(size_t)blockIdx.x * D + c] = v;
    }
  for (int c = 0; c < tiles; ++c) {
    if (u != nullptr) {
      // u's tile joins the ring's next commit group, so the product's
      // third step waits for it
      __syncthreads();  // the last epilogue has read U
      static_assert(BM * N / 4 % NT == 0, "whole float4 copies a thread");
#pragma unroll
      for (int k = 0; k < BM * N / 4 / NT; ++k) {
        const int idx = threadIdx.x + k * NT, r = idx / (N / 4), cc = 4 * (idx % (N / 4));
        const bool ok = m0 + r < p.M && c * N + cc < p.ncols;
        cp_async16(U + r * N + cc, ok ? u + (size_t)(m0 + r) * p.ldu + c * N + cc : u, ok);
      }
    }
    float acc[BM / 8][N / 32];
    zero(acc);
    block_mma<BM, N, R::LDA, R::DEPTH, R::STAGES>(acc, AT, w(c), w(c + 1), ring);
    if (u != nullptr) {
      // the epilogue's gelu'(u), from the tile in shared memory
#pragma unroll
      for (int i = 0; i < L::RT; ++i)
#pragma unroll
        for (int h = 0; h < L::CT / 4; ++h) {
          const float4 uu =
              *reinterpret_cast<const float4*>(U + L::row(i) * N + L::col(4 * h));
          acc[i][4 * h] *= gelu_grad(uu.x);
          acc[i][4 * h + 1] *= gelu_grad(uu.y);
          acc[i][4 * h + 2] *= gelu_grad(uu.z);
          acc[i][4 * h + 3] *= gelu_grad(uu.w);
        }
    }
    nn_store<BM, N>(p, m0, c * N, acc);
  }
}

// One weight-gradient product of a tn launch: out(m, n) = sum over the
// split's token rows k of A(k, m) B[k * ldb + n], A k-major (a[k * lda +
// m], m < rows) and through the GELU when gelu; stored at off in each
// split's block of partial sums, at out[m * ldo + n] or, when trans, at
// out[n * ldo + m].  With csum, the split's sums of A's columns (before
// the GELU) go to coff + m in the same block.
struct TNProduct {
  const float* a;
  int lda, rows;
  const float* b;
  int ldb, gelu, trans, csum;
  size_t off, coff;
  int ldo;
};

constexpr int TN_MAX = 3;  // products a launch

// Products p[0 .. np) over K token rows, the columns n < ncols of each;
// their row tiles one after another in grid x (product i's from
// tile0[i]), split z of the rows ([z * rows_per_split, ...)) into the
// partial block at part + z * split.
struct TNArgs {
  TNProduct p[TN_MAX];
  int np, tile0[TN_MAX + 1];
  int K, rows_per_split, ncols;
  float* part;
  size_t split;
};

// Grid (tile0[np], ceil(ncols / N), splits).
template <int BM, int N>
__global__ void __launch_bounds__(NT, 1) tn_kernel(const TNArgs p) {
  using L = Mma<BM, N>;
  extern __shared__ __align__(16) float smem[];
  int i = 0;
  while (i + 1 < p.np && (int)blockIdx.x >= p.tile0[i + 1]) ++i;
  const TNProduct& q = p.p[i];
  const int m0 = (blockIdx.x - p.tile0[i]) * BM, n0 = blockIdx.y * N;
  const int k0 = blockIdx.z * p.rows_per_split, k1 = min(p.K, k0 + p.rows_per_split);
  float acc[BM / 8][N / 32];
  float4 cs = make_float4(0.f, 0.f, 0.f, 0.f);
  zero(acc);
  stream_mma<BM, N, false>(acc, smem, Opnd{q.a, q.lda, q.rows}, m0, q.b, q.ldb, n0, p.ncols,
                           k0, k1, q.gelu != 0, cs);
  if (q.csum && blockIdx.y == 0) {
    // the column groups' partial sums, added over the threads in order
    constexpr int G = BM / 4;
    float4* red = reinterpret_cast<float4*>(smem);
    red[threadIdx.x] = cs;
    __syncthreads();
    const int m = m0 + 4 * threadIdx.x;
    if (threadIdx.x < G && m < q.rows) {
      float4 t = red[threadIdx.x];
      for (int j = 1; j < NT / G; ++j) {
        const float4 v = red[threadIdx.x + j * G];
        t = make_float4(t.x + v.x, t.y + v.y, t.z + v.z, t.w + v.w);
      }
      *reinterpret_cast<float4*>(p.part + blockIdx.z * p.split + q.coff + m) = t;
    }
  }
  // rows row .. row + 3 of a float4 group are all below q.rows or none
  float* out = p.part + blockIdx.z * p.split + q.off;
#pragma unroll
  for (int ii = 0; ii < L::RT / 4; ++ii) {
    const int row = m0 + L::row(4 * ii);
    if (row >= q.rows) continue;
#pragma unroll
    for (int h = 0; h < L::CT / 4; ++h) {
      const int col = n0 + L::col(4 * h);
      if (col >= p.ncols) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float(&r)[L::CT] = acc[4 * ii + e];
        if (q.trans)  // four neighbouring rows of a column: one 16-byte store
          *reinterpret_cast<float4*>(out + (size_t)(col + e) * q.ldo + row) =
              make_float4(acc[4 * ii][4 * h + e], acc[4 * ii + 1][4 * h + e],
                          acc[4 * ii + 2][4 * h + e], acc[4 * ii + 3][4 * h + e]);
        else
          *reinterpret_cast<float4*>(out + (size_t)(row + e) * q.ldo + col) =
              make_float4(r[4 * h], r[4 * h + 1], r[4 * h + 2], r[4 * h + 3]);
      }
    }
  }
}

// out[i] = sum_{z < S} part[z * stride + i], i < n (a multiple of 4): a
// block takes 128 of the i, each of its 8 warps a run of S / 8 parts in
// order, and the runs are added in order (a fixed order: the same bits
// from run to run, with 8 chains of loads in flight where a long S, the
// LayerNorms' 32-row blocks, would leave one).
// sum_split_kernel's block bx (NT threads).
__device__ __forceinline__ void sum_split_block(const float* __restrict__ part, int S,
                                                size_t stride, int n, float* __restrict__ out,
                                                int bx) {
  __shared__ float4 red[NT / 32][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = 4 * (bx * 32 + lane);
  const int per = (S + NT / 32 - 1) / (NT / 32), z0 = warp * per, z1 = min(S, z0 + per);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n)
    for (int z = z0; z < z1; ++z) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(part + z * stride + i));
      if (z == z0) {
        acc = v;
      } else {
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && i < n) {
    for (int w = 1; w < NT / 32 && w * per < S; ++w) {
      const float4 v = red[w][lane];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    *reinterpret_cast<float4*>(out + i) = acc;
  }
}

__global__ void __launch_bounds__(NT) sum_split_kernel(const float* __restrict__ part, int S,
                                                       size_t stride, int n,
                                                       float* __restrict__ out) {
  sum_split_block(part, S, stride, n, out, blockIdx.x);
}

// ---- host side ------------------------------------------------------------
// Internal linkage: each launcher's flag that its kernel's shared-memory
// ceiling is set must be one per shared library, as each library has its
// own CUDA runtime to set it in (the static local of an inline function
// with external linkage is one object for the whole process).

template <int BM, int N>
static int nn(const NNArgs& p, cudaStream_t st) {
  constexpr int smem = Stream<BM, N, true>::SMEM;
  static bool ready = false;
  cudaError_t e = allow_smem(nn_kernel<BM, N>, smem, ready);
  if (e != cudaSuccess) return (int)e;
  if (p.M <= 0 || p.ncols <= 0) return 0;
  nn_kernel<BM, N><<<dim3((p.M + BM - 1) / BM, (p.ncols + N - 1) / N), NT, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// out (M x ncols) = A W with A's BM-row tiles resident (K = D); csum as
// nnr_kernel takes it (ceil(M / BM) x D floats, or null).
template <int BM, int N, int D>
static int nnr(const NNArgs& p, float* csum, cudaStream_t st) {
  constexpr int smem = Resident<BM, N, D>::SMEM;
  static bool ready = false;
  cudaError_t e = allow_smem(nnr_kernel<BM, N, D>, smem, ready);
  if (e != cudaSuccess) return (int)e;
  if (p.K != D) return (int)cudaErrorInvalidValue;
  if (p.M <= 0 || p.ncols <= 0) return 0;
  nnr_kernel<BM, N, D><<<(p.M + BM - 1) / BM, NT, smem, st>>>(p, csum);
  return (int)cudaGetLastError();
}

// The products' partial sums over `splits` row ranges into part (each
// split's block `split` floats), tile0 filled in here.
template <int BM, int N>
static int tn(TNArgs p, int splits, cudaStream_t st) {
  constexpr int smem = Stream<BM, N, false>::SMEM;
  static bool ready = false;
  cudaError_t e = allow_smem(tn_kernel<BM, N>, smem, ready);
  if (e != cudaSuccess) return (int)e;
  if (p.np < 1 || p.np > TN_MAX || splits < 1) return (int)cudaErrorInvalidValue;
  p.tile0[0] = 0;
  for (int i = 0; i < p.np; ++i) p.tile0[i + 1] = p.tile0[i] + (p.p[i].rows + BM - 1) / BM;
  p.rows_per_split = rows_per_split(p.K, splits);
  tn_kernel<BM, N><<<dim3(p.tile0[p.np], (p.ncols + N - 1) / N, splits), NT, smem, st>>>(p);
  return (int)cudaGetLastError();
}

inline int sum_split(const float* part, int S, size_t stride, int n, float* out,
                     cudaStream_t st) {
  sum_split_kernel<<<(n / 4 + 31) / 32, NT, 0, st>>>(part, S, stride, n, out);
  return (int)cudaGetLastError();
}

}  // namespace kit
