// Building blocks of the int8 serving kernels (int8_matmul.cu, ffn.cu,
// layer_fused.cu), on the block layout of common.cuh.
//
// Quantization is the TPU kernels' (ops/pallas/int8_matmul.py::_kernel,
// ffn.py::_quant_rows): per row, s = max(amax, 1e-12) * (1 / 127) and
// q = clip(rint(x * (1 / s)), -127, 127), rint rounding half to even as
// jnp.round does.  Weights arrive quantized, per output column, in torch's
// Linear layout (one int8 row of K values per output column), so that four
// consecutive k of a column are one 32-bit word.  The product is __dp4a on
// such words with int32 accumulation: exact, since |acc| <= K * 127^2 <
// 2^31 for K up to 2^17.  The dequantization float(acc) * s * w_scale (+
// bias) is written with __fmul_rn / __fadd_rn, so no multiply-add is fused
// and it rounds as the plain versions' separate operations do.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace kit {

constexpr int KW = 16;  // 32-bit words (64 int8 k) per staged weight tile

__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(amax, 1e-12f) * (1.f / 127.f);
}

__device__ __forceinline__ uint32_t quant(float x, float inv) {
  return (uint32_t)(int)fminf(fmaxf(rintf(x * inv), -127.f), 127.f) & 0xffu;
}

// Four quantized values in one word, the first in the low byte (k order).
__device__ __forceinline__ int pack4(float x0, float x1, float x2, float x3, float inv) {
  return (int)(quant(x0, inv) | quant(x1, inv) << 8 | quant(x2, inv) << 16 |
               quant(x3, inv) << 24);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// float(acc) * s * w_scale, rounded as the plain versions' two products.
__device__ __forceinline__ float dequant(int acc, float s, float ws) {
  return __fmul_rn(__fmul_rn((float)acc, s), ws);
}

// Quantize the thread's RM rows (one warp per row, columns as common.cuh
// lays them out) into A, k-major words: A[w * LD + row] holds k = 4w ..
// 4w + 3 of the block's row.  s[i] receives row i's scale.  RM and LD:
// rows a warp and the words' row stride, TM and LDT in a 32-row block,
// 8 and 68 in the whole-layer kernels' 64-row tiles.
template <int TN, int RM = TM, int LD = LDT>
__device__ __forceinline__ void quant_rows(const float (&v)[RM][TN], int* A, float (&s)[RM]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) a = fmaxf(a, fabsf(v[i][j]));
    s[i] = row_scale(warp_max(a));
    const float inv = 1.f / s[i];
#pragma unroll
    for (int g = 0; g < TN / 4; ++g)
      A[(lane + 32 * g) * LD + row_of<RM>(i)] =
          pack4(v[i][4 * g], v[i][4 * g + 1], v[i][4 * g + 2], v[i][4 * g + 3], inv);
  }
}

// acc[i][j] += sum over words w < nw of dp4a(A[w * LD + row_of<RM>(i)],
// Ws[w * ldw + col_of(j)]): the block's quantized rows against a staged
// weight tile, both k-major in shared memory (ldw a multiple of 4).
template <int TN, int RM = TM, int LD = LDT>
__device__ __forceinline__ void imma_tile(int (&acc)[RM][TN], const int* A, const int* Ws,
                                          int ldw, int nw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 4
  for (int w = 0; w < nw; ++w) {
    int a[RM];
#pragma unroll
    for (int q = 0; q < RM; q += 4) {
      const int4 a4 = *reinterpret_cast<const int4*>(A + w * LD + RM * warp + q);
      a[q] = a4.x;
      a[q + 1] = a4.y;
      a[q + 2] = a4.z;
      a[q + 3] = a4.w;
    }
    int b[TN];
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int4 b4 = *reinterpret_cast<const int4*>(Ws + w * ldw + 4 * lane + 128 * g);
      b[4 * g] = b4.x;
      b[4 * g + 1] = b4.y;
      b[4 * g + 2] = b4.z;
      b[4 * g + 3] = b4.w;
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_{k < K} A[row_of(i)][k] Wq[col_of(j)][k].  A: the
// block's rows quantized, k-major words in shared memory as quant_rows
// writes them.  Wq: (ncols, ldw) int8 in device memory, one row per output
// column, 4-byte aligned; ldw and K multiples of 4; columns >= ncols read
// as 0.  Ws: shared scratch of KW * (32 TN + 4) words (the padding keeps
// the staging stores off one bank).  Ends with a barrier.  RM, LD as
// quant_rows takes them.
template <int TN, int RM = TM, int LD = LDT>
__device__ __forceinline__ void imma_rows(int (&acc)[RM][TN], const int* A, int K,
                                          const int8_t* __restrict__ Wq, int ldw, int ncols,
                                          int* Ws) {
  constexpr int N = 32 * TN, LDW = N + 4, PER = KW * N / NT;
  static_assert(KW * N % NT == 0, "whole words a thread");
  const int words = K / 4;
  // a column's words next to each other: one row of Wq read in one go.
  // The next tile's words are loaded into registers while this one is
  // multiplied, so a block does not wait on its loads.
  int val[PER];
  auto load = [&](int w0) {
    const int nw = min(KW, words - w0);
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int idx = threadIdx.x + u * NT, c = idx / KW, w = idx - c * KW;
      val[u] = 0;
      if (c < ncols && w < nw)
        val[u] = __ldg(reinterpret_cast<const int*>(Wq + (size_t)c * ldw) + w0 + w);
    }
  };
  if (words > 0) load(0);
  for (int w0 = 0; w0 < words; w0 += KW) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int idx = threadIdx.x + u * NT, c = idx / KW, w = idx - c * KW;
      Ws[w * LDW + c] = val[u];
    }
    __syncthreads();
    if (w0 + KW < words) load(w0 + KW);
    imma_tile<TN, RM, LD>(acc, A + w0 * LD, Ws, LDW, min(KW, words - w0));
    __syncthreads();
  }
}

// One FF sublayer's int8 weights, torch's Linear layout, per-output-column
// scales in the FF kernels' form (ffn.py:329-334).
struct FFInt8 {
  const int8_t* w1q;  // (n, D)
  const float* w1s;   // (n)
  const float* b1;    // (n)
  const int8_t* w2q;  // (D, n)
  const float* w2s;   // (D)
  const float* b2;    // (D)
  int n;              // the FF width, a multiple of 4
};

// The body of ops/pallas/ffn.py::_kernel_int8 after its LN1, for one tile
// of rows in the common.cuh layout:
//     u = int8(x1) W1q * s1 * w1s + b1;  h = gelu(u)  (exact erf)
//     z = (x1 + int8(h) W2q * s2 * w2s) + b2          (s1, s2 per row)
// Xs holds x1 on entry (as put_rows leaves it) and z (before LN2) on exit,
// each thread's own values, so the caller reads them back with get_rows and
// no barrier.  The second product quantizes each row of h over the whole FF
// width, so a row's scale is known only once all of its h is: the first
// pass writes h to h_out (the tile's rows, row stride ldh, rows < rows) and
// tracks each row's absmax; the second reads back the values the same
// thread wrote (plain loads, in program order), quantizes them one D-wide
// chunk at a time into shared memory and runs the product.  Hs: free
// shared D x LD floats (D / 2 x LD + KW x (D + 4) words are used).  The
// tile is 8 RM rows, k-major with row stride LD in Xs and Hs (RM = TM and
// LD = LDT: a 32-row block).  Not inlined: the float kernels that also
// take this path keep their own code and registers.
template <int TN, int RM = TM, int LD = LDT>
__device__ __noinline__ void ff_int8_rows(float* Xs, float* Hs, const FFInt8 f, float* h_out,
                                          int ldh, int rows) {
  constexpr int D = 32 * TN;
  const int lane = threadIdx.x & 31;
  int* Aq = reinterpret_cast<int*>(Hs);  // D / 4 x LD words: int8(x1)
  int* Hq = Aq + D / 4 * LD;             // D / 4 x LD words: int8(h), one chunk
  int* Wi = Hq + D / 4 * LD;             // KW x (D + 4) words: a weight tile
  float v[RM][TN];
  get_rows<TN, LD>(v, Xs);  // x1, kept in Xs for the residual
  float s1[RM];
  quant_rows<TN, RM, LD>(v, Aq, s1);
  __syncthreads();
  float amax[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) amax[i] = 0.f;
  int acc[RM][TN];
  for (int f0 = 0; f0 < f.n; f0 += D) {
    const int fc = min(D, f.n - f0);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0;
    imma_rows<TN, RM, LD>(acc, Aq, D, f.w1q + (size_t)f0 * D, D, fc, Wi);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = col_of(j);
        float hv = 0.f;
        if (c < fc)
          hv = gelu(__fadd_rn(dequant(acc[i][j], s1[i], __ldg(f.w1s + f0 + c)),
                              __ldg(f.b1 + f0 + c)));
        amax[i] = fmaxf(amax[i], fabsf(hv));
        v[i][j] = hv;
      }
    store_rows<TN>(h_out + f0, ldh, fc, 0, rows, v);
  }
  float s2[RM], inv2[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    s2[i] = row_scale(warp_max(amax[i]));
    inv2[i] = 1.f / s2[i];
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;
  for (int f0 = 0; f0 < f.n; f0 += D) {
    const int fc = min(D, f.n - f0);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = row_of<RM>(i);
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const int c = col_of(4 * g);
        float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < rows && c < fc)
          hv = *reinterpret_cast<const float4*>(h_out + (size_t)row * ldh + f0 + c);
        Hq[(lane + 32 * g) * LD + row] = pack4(hv.x, hv.y, hv.z, hv.w, inv2[i]);
      }
    }
    __syncthreads();
    imma_rows<TN, RM, LD>(acc, Hq, fc, f.w2q + f0, f.n, D, Wi);
  }
  get_rows<TN, LD>(v, Xs);
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col_of(j);
      v[i][j] = __fadd_rn(__fadd_rn(v[i][j], dequant(acc[i][j], s2[i], __ldg(f.w2s + c))),
                          __ldg(f.b2 + c));
    }
  put_rows<TN, LD>(Xs, v);
}

// ---- the int8 FF sublayer (ffn.cu kit_ffn_int8; layer_modes.cu runs it as
// the int8 merged encoder layer's tail in a mode) ---------------------------

// The int8 forward: x1 = LN1(r) (with g1), z = ff_int8_rows(x1), y =
// LN2(z); h (M, f.n) is the scratch ff_int8_rows keeps each row's GELU
// output in.
template <int TN>
__global__ void __launch_bounds__(NT)
ffn_int8_kernel(const float* __restrict__ r, int M, int n, const FFInt8 f,
                const float* __restrict__ g1, const float* __restrict__ be1,
                const float* __restrict__ g2, const float* __restrict__ be2,
                float* __restrict__ y, float* h) {
  constexpr int D = 32 * TN;
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;            // D x LDT
  float* Hs = smem + D * LDT;  // D x LDT
  const int row0 = blockIdx.x * BM;
  stage_rows(Xs, r, D, row0, M, D);
  __syncthreads();
  float v[TM][TN];
  get_rows<TN>(v, Xs);
  if (g1 != nullptr) {
    layer_norm<TN>(v, g1, be1, n);
    put_rows<TN>(Xs, v);  // each thread rewrites only what it read
  }
  ff_int8_rows<TN>(Xs, Hs, f, h + (size_t)row0 * f.n, f.n, min(BM, M - row0));
  get_rows<TN>(v, Xs);
  layer_norm<TN>(v, g2, be2, n);
  store_rows<TN>(y, D, D, row0, M, v);
}

// One launch of ffn_int8_kernel over M rows.  Internal linkage: see
// sgemm_grad.cuh's host side (ffn.cu and layer_modes.cu each set the
// shared-memory ceiling of their own copy of the kernel).
template <int TN>
static int launch_int8(const float* r, int M, int n, const FFInt8& f, const float* g1,
                       const float* be1, const float* g2, const float* be2, float* y, float* h,
                       cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int smem = 2 * D * LDT * sizeof(float);
  static bool ready = false;
  cudaError_t e = allow_smem(ffn_int8_kernel<TN>, smem, ready);
  if (e != cudaSuccess) return (int)e;
  ffn_int8_kernel<TN><<<(M + BM - 1) / BM, NT, smem, st>>>(r, M, n, f, g1, be1, g2, be2, y, h);
  return (int)cudaGetLastError();
}

}  // namespace kit
