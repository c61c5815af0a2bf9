// Building blocks of the port's backward kernels (included by ffn.cu and
// attn_sublayer.cu), on the block layout of common.cuh: the GELU's
// derivative, the LayerNorm forward and backward over rows (each can also
// write its output as the bf16 hi / lo planes the tensor-core backward
// reads), and the column and partial sums of the tensor-core split
// backward.
//
// Reductions across rows never use atomics: a kernel writes one partial
// sum per block (or per row split) into scratch the wrapper allocates, and
// sum_parts_kernel adds the partials in a fixed order, so every gradient
// is the same from run to run.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace kit {

// hi = bf16(x), lo = bf16(x - hi), both round-to-nearest-even (x - hi is
// exact in float32): the split of the precision modes.  Two values at once,
// packed as a bf16 pair (the first in the low half).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Store the thread's values of rows < M as bf16 hi / lo planes (row stride
// D = 32 * TN; lo null: hi only), as store_rows stores them in float32.
template <int TN>
__device__ __forceinline__ void store_planes(__nv_bfloat16* hi, __nv_bfloat16* lo, int row0,
                                             int M, const float (&v)[TM][TN]) {
  constexpr int D = 32 * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + row_of(i);
    if (row >= M) continue;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const size_t o = (size_t)row * D + col_of(4 * g);
      uint32_t h0, l0, h1, l1;
      split2(v[i][4 * g], v[i][4 * g + 1], h0, l0);
      split2(v[i][4 * g + 2], v[i][4 * g + 3], h1, l1);
      *reinterpret_cast<uint2*>(hi + o) = make_uint2(h0, h1);
      if (lo != nullptr) *reinterpret_cast<uint2*>(lo + o) = make_uint2(l0, l1);
    }
  }
}

// d/du [u * Phi(u)] = Phi(u) + u * phi(u), exact erf (the forward's GELU).
__device__ __forceinline__ float gelu_grad(float u) {
  const float cdf = 0.5f * (1.f + erff(u * 0.70710678118654752f));
  const float pdf = 0.3989422804014327f * expf(-0.5f * u * u);
  return fmaf(u, pdf, cdf);
}

// The thread's TM x TN values of rows [row0, row0 + BM) (zero for rows >=
// M) of a row-major matrix with D = 32 * TN columns and row stride ld (a
// multiple of 4), one 16-byte load per row and column group.
template <int TN>
__device__ __forceinline__ void load_rows(float (&v)[TM][TN], const float* __restrict__ src,
                                          int ld, int row0, int M) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + row_of(i);
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < M)
        x = __ldg(reinterpret_cast<const float4*>(src + (size_t)row * ld + col_of(4 * g)));
      v[i][4 * g] = x.x;
      v[i][4 * g + 1] = x.y;
      v[i][4 * g + 2] = x.z;
      v[i][4 * g + 3] = x.w;
    }
  }
}

// Column sums over the block's BM rows of the thread's values: out[c] for
// c < ncols.  red: shared scratch of 8 * 32 * TN floats.  Fixed order (the
// thread's 4 rows, then the 8 warps in turn).  Starts and ends with a
// barrier.
template <int TN>
__device__ __forceinline__ void block_colsum(const float (&v)[TM][TN], float* red,
                                             float* __restrict__ out, int ncols) {
  constexpr int D = 32 * TN;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < TN; ++j)
    red[warp * D + col_of(j)] = ((v[0][j] + v[1][j]) + v[2][j]) + v[3][j];
  __syncthreads();
  for (int c = threadIdx.x; c < ncols; c += NT) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += red[w * D + c];
    out[c] = s;
  }
  __syncthreads();
}

// LayerNorm over rows [0, M) of width D = 32 * TN (one warp per row), its
// statistics over the first nw columns (see common.cuh): out = norm(x) *
// gamma + beta, and its bf16 planes when hi is not null (store_planes).
template <int TN>
__global__ void __launch_bounds__(NT)
ln_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, int M, int nw, float* __restrict__ out,
              __nv_bfloat16* hi = nullptr, __nv_bfloat16* lo = nullptr) {
  constexpr int D = 32 * TN;
  float v[TM][TN];
  load_rows<TN>(v, x, D, blockIdx.x * BM, M);
  layer_norm<TN>(v, gamma, beta, nw);
  store_rows<TN>(out, D, D, blockIdx.x * BM, M, v);
  if (hi != nullptr) store_planes<TN>(hi, lo, blockIdx.x * BM, M, v);
}

// Backward of y = norm(x) * gamma + beta over rows [0, M) of width D =
// 32 * TN (statistics over the first nw columns, dx 0 beyond them), given
// dy: dx, and the block's partial sums of dy * norm(x) (part[0, D)) and of
// dy (part[D, 2D)) at part + blockIdx.x * 2D; dx's bf16 planes too when hi
// is not null (store_planes), and the block's column sums of dx at
// dxsum + blockIdx.x * D when dxsum is not null.  dx may be dy: each thread
// reads all its values before it writes them.
template <int TN>
__global__ void __launch_bounds__(NT)
ln_bwd_kernel(const float* dy, const float* __restrict__ x, const float* __restrict__ gamma,
              int M, int nw, float* dx, float* __restrict__ part,
              __nv_bfloat16* hi = nullptr, __nv_bfloat16* lo = nullptr,
              float* __restrict__ dxsum = nullptr) {
  constexpr int D = 32 * TN;
  const float inv_n = 1.f / nw;
  __shared__ float red[8 * D];
  const int row0 = blockIdx.x * BM;
  float n[TM][TN], g[TM][TN];
  load_rows<TN>(n, x, D, row0, M);
  load_rows<TN>(g, dy, D, row0, M);
  float inv[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) s += col_of(j) < nw ? n[i][j] : 0.f;
    const float mean = warp_sum(s) * inv_n;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      n[i][j] = col_of(j) < nw ? n[i][j] - mean : 0.f;
      ss += n[i][j] * n[i][j];
    }
    inv[i] = rsqrtf(warp_sum(ss) * inv_n + LN_EPS);
#pragma unroll
    for (int j = 0; j < TN; ++j) n[i][j] *= inv[i];
  }
  float t[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) t[i][j] = g[i][j] * n[i][j];
  float* out = part + (size_t)blockIdx.x * 2 * D;
  block_colsum<TN>(t, red, out, D);
  block_colsum<TN>(g, red, out + D, D);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float dn = g[i][j] * __ldg(gamma + col_of(j));
      t[i][j] = dn;
      s1 += dn;
      s2 += dn * n[i][j];
    }
    const float m1 = warp_sum(s1) * inv_n, m2 = warp_sum(s2) * inv_n;
#pragma unroll
    for (int j = 0; j < TN; ++j)
      t[i][j] = col_of(j) < nw ? (t[i][j] - m1 - n[i][j] * m2) * inv[i] : 0.f;
  }
  if (dxsum != nullptr) block_colsum<TN>(t, red, dxsum + (size_t)blockIdx.x * D, D);
  store_rows<TN>(dx, D, D, row0, M, t);
  if (hi != nullptr) store_planes<TN>(hi, lo, row0, M, t);
}

// part[z * N + j] = sum of X[r * ld + j] over rows r of split z
// ([z * rows, min(M, (z + 1) * rows))), j < N, in row order.
__global__ void colsum_kernel(const float* __restrict__ X, int ld, int M, int N, int rows,
                              float* __restrict__ part) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  const int r1 = min(M, (int)(blockIdx.y + 1) * rows);
  float s = 0.f;
  for (int r = blockIdx.y * rows; r < r1; ++r) s += __ldg(X + (size_t)r * ld + j);
  part[(size_t)blockIdx.y * N + j] = s;
}

// out[i] = sum_{z < S} part[z * N + i], in order of z; N a multiple of 4.
__global__ void sum_parts_kernel(const float* __restrict__ part, int S, int N,
                                 float* __restrict__ out) {
  const int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= N) return;
  float4 acc = __ldg(reinterpret_cast<const float4*>(part + i));
  for (int z = 1; z < S; ++z) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(part + (size_t)z * N + i));
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  *reinterpret_cast<float4*>(out + i) = acc;
}

// ---- host side -------------------------------------------------------------

inline int rows_per_split(int M, int splits) { return ((M + splits - 1) / splits + 31) / 32 * 32; }

inline int sum_parts(const float* part, int S, int N, float* out, cudaStream_t st) {
  sum_parts_kernel<<<(N / 4 + 255) / 256, 256, 0, st>>>(part, S, N, out);
  return (int)cudaGetLastError();
}

inline int colsum(const float* X, int ld, int M, int N, int splits, float* part, float* out,
                  cudaStream_t st) {
  colsum_kernel<<<dim3((N + 127) / 128, splits), 128, 0, st>>>(X, ld, M, N,
                                                              rows_per_split(M, splits), part);
  int rc = (int)cudaGetLastError();
  return rc ? rc : sum_parts(part, splits, N, out, st);
}

}  // namespace kit
