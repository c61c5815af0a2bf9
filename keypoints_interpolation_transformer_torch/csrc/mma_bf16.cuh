// The bf16 tensor-core product core of the precision modes "high" and
// "default" (used by ffn.cu).
//
// Replaces the TPU arithmetic of keypoints_interpolation_transformer_tpu/
// ops/pallas/ffn.py under those modes: _split_hi_lo / _split_hi_lo_kernel
// (a float32 x becomes hi = bf16(x) and lo = bf16(x - hi), both rounded to
// nearest even), _dot3 / _dot_parts (a product of split operands is A_hi
// B_hi + A_hi B_lo + A_lo B_hi, every term summed in float32: "high", XLA's
// bf16_3x on the TPU) and the single bf16 pass of _prep_act ("default",
// A_hi B_hi).  A product of two bf16 values is exact in float32, so only
// the rounding of the operands and the order of the float32 sums differ
// from the plain version (ops/kernels/precision.py).
//
// On Hopper each term is one mma.sync.aligned.m16n8k16 (bf16 in, float32
// accumulate): PASSES = 3 issues the three terms into one accumulator,
// PASSES = 1 the first only.  What bounds it: the tensor-core rate, 989
// TFLOP/s of bf16 on an H100 (so 3 x the FLOP of the float32 product for
// "high"), as long as the tiles come from shared memory fast enough; the
// kernels here stage one tile at a time and wait for it (no cp.async
// pipeline, no wgmma: simple first, fast later).
//
// Shared-memory tiles hold an operand as two bf16 planes, hi and lo, each
// row-major with the contraction (k) axis contiguous: A as [m][k], B as
// [n][k] (the "col" operand of mma.sync).  A row stride of K + 8 bf16
// (K a multiple of 32) puts the 8 rows x 4 words a warp reads for one
// fragment in 32 different banks.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace kit {

typedef __nv_bfloat16 bf16;

// hi = bf16(x), lo = bf16(x - hi), both round-to-nearest-even; x - hi is
// exact in float32.  Two values at once, packed as the mma operands want
// them (the lower k in the low half).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Store 4 consecutive values of one row (k .. k + 3) split into the planes.
__device__ __forceinline__ void put_split4(bf16* hi, bf16* lo, float4 v) {
  uint32_t h0, l0, h1, l1;
  split2(v.x, v.y, h0, l0);
  split2(v.z, v.w, h1, l1);
  *reinterpret_cast<uint2*>(hi) = make_uint2(h0, h1);
  *reinterpret_cast<uint2*>(lo) = make_uint2(l0, l1);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a b for one m16n8k16 tile: a the 4 registers of the A fragment
// (rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9), b the 2 of the
// B fragment (column g, rows 2t, 2t + 1 and 2t + 8, 2t + 9), c rows g and
// g + 8, columns 2t, 2t + 1 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The warp's MI x NJ tiles of 16 x 8: acc[i][j] += sum_{k < KS} A[16 i +
// r][k] B[8 j + c][k] in the mode's passes.  Ah / Al point at the warp's
// first A row (row stride lda), Bh / Bl at its first B row (stride ldb),
// both at the first k; KS a multiple of 16.  The lo planes are read only
// when PASSES == 3.
template <int MI, int NJ, int PASSES>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NJ][4], const bf16* Ah, const bf16* Al,
                                         int lda, const bf16* Bh, const bf16* Bl, int ldb,
                                         int KS) {
  static_assert(PASSES == 1 || PASSES == 3, "one pass (bf16) or three (bf16x3)");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int k = 0; k < KS; k += 16) {
    uint32_t ah[MI][4], al[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int o = (16 * i + g) * lda + k + 2 * t;
      ah[i][0] = ld32(Ah + o);
      ah[i][1] = ld32(Ah + o + 8 * lda);
      ah[i][2] = ld32(Ah + o + 8);
      ah[i][3] = ld32(Ah + o + 8 * lda + 8);
      if constexpr (PASSES == 3) {
        al[i][0] = ld32(Al + o);
        al[i][1] = ld32(Al + o + 8 * lda);
        al[i][2] = ld32(Al + o + 8);
        al[i][3] = ld32(Al + o + 8 * lda + 8);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int o = (8 * j + g) * ldb + k + 2 * t;
      const uint32_t bh[2] = {ld32(Bh + o), ld32(Bh + o + 8)};
#pragma unroll
      for (int i = 0; i < MI; ++i) mma16816(acc[i][j], ah[i], bh);
      if constexpr (PASSES == 3) {
        const uint32_t bl[2] = {ld32(Bl + o), ld32(Bl + o + 8)};
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma16816(acc[i][j], ah[i], bl);
          mma16816(acc[i][j], al[i], bh);
        }
      }
    }
  }
}

template <int MI, int NJ>
__device__ __forceinline__ void zero_acc(float (&acc)[MI][NJ][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Where value e of tile (i, j) of the warp's accumulator sits: row 16 i + g
// (+ 8 for e >= 2), column 8 j + 2 t + (e & 1), relative to the warp's tile.
__device__ __forceinline__ int acc_row(int i, int e) {
  return 16 * i + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int j, int e) {
  return 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
}

// ---- staging of operand tiles ---------------------------------------------
//
// Each fills R rows x TK (= 32) k-columns of a hi / lo plane pair (row
// stride LDS = TK + 8) from element (i0 + i, k0 + kk), zero where i0 + i >=
// I or k0 + kk >= kend.

constexpr int TK = 32;
constexpr int LDS = TK + 8;

// Pre-split bf16 planes, element (i, k) at p[i * ld + k] (ld and k0 multiples
// of 8, kend too): one 16-byte copy per 8 values.
struct SplitRows {
  const bf16 *hi, *lo;
  int ld;
  template <int R>
  __device__ __forceinline__ void stage(bf16* sh, bf16* sl, int i0, int I, int k0,
                                        int kend) const {
    for (int idx = threadIdx.x; idx < R * TK / 8; idx += NT) {
      const int i = idx / (TK / 8), c = 8 * (idx - i * (TK / 8));
      const bool in = i0 + i < I && k0 + c < kend;
      const size_t o = (size_t)(i0 + i) * ld + k0 + c;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(sh + i * LDS + c) =
          in ? __ldg(reinterpret_cast<const uint4*>(hi + o)) : zero;
      if (lo != nullptr)
        *reinterpret_cast<uint4*>(sl + i * LDS + c) =
            in ? __ldg(reinterpret_cast<const uint4*>(lo + o)) : zero;
    }
  }
};

// float32, element (i, k) at p[i * ld + k] (ld, k0 and kend multiples of 4),
// split as it is staged.
struct F32Rows {
  const float* p;
  int ld;
  template <int R>
  __device__ __forceinline__ void stage(bf16* sh, bf16* sl, int i0, int I, int k0,
                                        int kend) const {
    for (int idx = threadIdx.x; idx < R * TK / 4; idx += NT) {
      const int i = idx / (TK / 4), c = 4 * (idx - i * (TK / 4));
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i0 + i < I && k0 + c < kend)
        v = __ldg(reinterpret_cast<const float4*>(p + (size_t)(i0 + i) * ld + k0 + c));
      put_split4(sh + i * LDS + c, sl + i * LDS + c, v);
    }
  }
};

// float32 read across rows, element (i, k) at f(p[k * ld + i]) (ld, i0 and
// I multiples of 4; kend any), f the GELU when GELU: the operands of the
// weight-gradient products, whose contraction runs over token rows.
template <bool GELU>
struct F32Cols {
  const float* p;
  int ld;
  template <int R>
  __device__ __forceinline__ void stage(bf16* sh, bf16* sl, int i0, int I, int k0,
                                        int kend) const {
    for (int idx = threadIdx.x; idx < TK * R / 4; idx += NT) {
      const int kk = idx / (R / 4), i = 4 * (idx - kk * (R / 4));
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + kk < kend && i0 + i < I) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(p + (size_t)(k0 + kk) * ld + i0 + i));
        v[0] = x.x;
        v[1] = x.y;
        v[2] = x.z;
        v[3] = x.w;
        if constexpr (GELU) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = gelu(v[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bf16 h = __float2bfloat16_rn(v[e]);
        sh[(i + e) * LDS + kk] = h;
        sl[(i + e) * LDS + kk] = __float2bfloat16_rn(v[e] - __bfloat162float(h));
      }
    }
  }
};

}  // namespace kit
