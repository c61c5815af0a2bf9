// Shared building blocks of the port's hand-written Hopper kernels.
//
// Every kernel works on blocks of NT = 256 threads (8 warps), the row
// kernels here on BM = 32 token rows (sgemm.cuh's products on 32- or
// 64-row tiles; the row helpers below take their rows per warp, RM, and
// row stride).  Warp w owns rows 4w .. 4w + 3 of the block; lane l
// owns columns 4l + e + 128 g (e < 4, g < TN / 4), so a row that is
// D = 32 * TN wide lives in ONE warp and a row reduction (LayerNorm,
// token_norm) is a warp shuffle, with no shared memory and no barrier.
//
// The row helpers here stage a block's activation rows k-major in shared
// memory (AT[k * LDT + r]) and move a warp's rows between registers and
// that layout.  The float32 products run on sgemm.cuh (the merged layers,
// the per-sublayer forwards, the pointwise chains and, streamed by
// sgemm_grad.cuh, the training backwards); int8.cuh multiplies 32-row
// blocks in this layout.
//
// Widths: the kernels are built for D = 32 * TN with TN = 4, 8, 12 or 16
// (D = 128 to 512; by_width dispatches).  A narrower model runs zero-padded
// to the next of these by its wrapper, with every weight, bias and
// LayerNorm parameter padded with zeros; the LayerNorms take the true width
// n and keep their statistics over it, and write 0 to the padded columns,
// so the padding never enters a mean and stays zero through every layer.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace kit {

constexpr int BM = 32;       // token rows per block
constexpr int BK = 16;       // contraction depth of one weight tile
constexpr int NT = 256;      // threads per block
constexpr int TM = 4;        // rows per thread (BM / 8 warps)
constexpr int LDT = BM + 4;  // k-major row stride of a staged block: keeps 16-byte alignment
constexpr float LN_EPS = 1e-5f;
constexpr float NEG = -1e9f;  // the finite blocker of ops/masks.py

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// Exact-erf GELU, u * Phi(u) (torch's "gelu").
__device__ __forceinline__ float gelu(float u) {
  return 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block row and the column that value (i, j) of this thread holds; a
// tile of 8 RM rows gives each warp RM of them (RM = TM = 4 in a BM-row
// block; the whole-layer kernels' 64-row tiles take RM = 8).
template <int RM = TM>
__device__ __forceinline__ int row_of(int i) { return RM * (threadIdx.x >> 5) + i; }
__device__ __forceinline__ int col_of(int j) {
  return 4 * (threadIdx.x & 31) + (j & 3) + 128 * (j >> 2);
}

// Stage rows [row0, row0 + BM) x [0, K) of src (row stride lds) k-major into
// AT, zero-filling rows >= M and columns [K, round_up(K, BK)).
__device__ __forceinline__ void stage_rows(float* AT, const float* __restrict__ src, int lds,
                                           int row0, int M, int K) {
  const int Kp = round_up(K, BK);
  for (int idx = threadIdx.x; idx < BM * Kp; idx += NT) {
    int r = idx / Kp, c = idx - r * Kp;
    int row = row0 + r;
    AT[c * LDT + r] = (row < M && c < K) ? src[(size_t)row * lds + c] : 0.f;
  }
}

// Normalize each of the thread's TM rows (one warp per row) over its first
// n <= 32 * TN columns to zero mean and unit variance: (x - m) *
// rsqrt(mean((x - m)^2) + eps); columns >= n become 0.
template <int TN, int RM>
__device__ __forceinline__ void row_norm(float (&v)[RM][TN], int n = 32 * TN) {
  const float inv_n = 1.f / n;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) s += col_of(j) < n ? v[i][j] : 0.f;
    float mean = warp_sum(s) * inv_n;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float d = col_of(j) < n ? v[i][j] - mean : 0.f;
      ss += d * d;
    }
    float inv = rsqrtf(warp_sum(ss) * inv_n + LN_EPS);
#pragma unroll
    for (int j = 0; j < TN; ++j) v[i][j] = col_of(j) < n ? (v[i][j] - mean) * inv : 0.f;
  }
}

// LayerNorm with affine parameters over the rows held in registers, its
// statistics over the first n columns (gamma and beta zero beyond them).
template <int TN, int RM>
__device__ __forceinline__ void layer_norm(float (&v)[RM][TN], const float* __restrict__ gamma,
                                           const float* __restrict__ beta, int n = 32 * TN) {
  row_norm<TN>(v, n);
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int c = col_of(j);
      v[i][j] = v[i][j] * __ldg(gamma + c) + __ldg(beta + c);
    }
}

// Write the thread's RM x TN values into the block's k-major shared rows
// (row stride LD).
template <int TN, int LD = LDT, int RM>
__device__ __forceinline__ void put_rows(float* AT, const float (&v)[RM][TN]) {
#pragma unroll
  for (int j = 0; j < TN; ++j)
#pragma unroll
    for (int g = 0; g < RM; g += 4)
      *reinterpret_cast<float4*>(AT + col_of(j) * LD + row_of<RM>(g)) =
          make_float4(v[g][j], v[g + 1][j], v[g + 2][j], v[g + 3][j]);
}

// Read back what put_rows (or stage_rows) left for this thread.
template <int TN, int LD = LDT, int RM>
__device__ __forceinline__ void get_rows(float (&v)[RM][TN], const float* AT) {
#pragma unroll
  for (int j = 0; j < TN; ++j)
#pragma unroll
    for (int g = 0; g < RM; g += 4) {
      const float4 r4 = *reinterpret_cast<const float4*>(AT + col_of(j) * LD + row_of<RM>(g));
      v[g][j] = r4.x;
      v[g + 1][j] = r4.y;
      v[g + 2][j] = r4.z;
      v[g + 3][j] = r4.w;
    }
}

// Store the thread's values of rows < M and columns < ncols to global
// memory (row stride ldo, a multiple of 4, as is ncols): one 16-byte
// store per row and column group.
template <int TN, int RM>
__device__ __forceinline__ void store_rows(float* out, int ldo, int ncols, int row0, int M,
                                           const float (&v)[RM][TN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    int row = row0 + row_of<RM>(i);
    if (row >= M) continue;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      int c = col_of(4 * g);
      if (c < ncols)
        *reinterpret_cast<float4*>(out + (size_t)row * ldo + c) =
            make_float4(v[i][4 * g], v[i][4 * g + 1], v[i][4 * g + 2], v[i][4 * g + 3]);
    }
  }
}

// Set the dynamic shared-memory ceiling of a kernel once per process.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel k, int bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = (e == cudaSuccess);
  return e;
}

// f(std::integral_constant<int, TN>) for the kernel width D = 32 * TN
// (128, 256, 384 or 512); cudaErrorInvalidValue for any other D.
template <typename F>
inline int by_width(int D, F&& f) {
  switch (D) {
    case 128: return f(std::integral_constant<int, 4>{});
    case 256: return f(std::integral_constant<int, 8>{});
    case 384: return f(std::integral_constant<int, 12>{});
    case 512: return f(std::integral_constant<int, 16>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace kit

// Each source builds into its own shared library with its own (static) CUDA
// runtime, so each exports these two helpers for its ctypes wrapper.
extern "C" const char* kit_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

extern "C" int kit_set_device(int device) { return (int)cudaSetDevice(device); }
