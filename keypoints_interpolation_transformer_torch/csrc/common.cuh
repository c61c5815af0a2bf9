// Shared building blocks of the port's hand-written Hopper kernels.
//
// Every kernel works on blocks of NT = 256 threads (8 warps), most on BM =
// 32 token rows (the whole-layer kernels on 64-row tiles, with sgemm.cuh's
// product; the row helpers below take their rows per warp, RM, and row
// stride).  Warp w owns rows 4w .. 4w + 3 of the block; lane l
// owns columns 4l + e + 128 g (e < 4, g < TN / 4), so a row that is
// D = 32 * TN wide lives in ONE warp and a row reduction (LayerNorm,
// token_norm) is a warp shuffle, with no shared memory and no barrier.
//
// Matrix products are plain float32 FFMA.  The block's activation rows sit
// in shared memory k-major (AT[k * LDT + r]), staged once per block; the
// weight is streamed through a BK x N shared tile; each thread keeps a
// TM x TN accumulator in registers.  One step of the inner loop is one
// 128-bit load of the thread's 4 rows of A, TN / 4 128-bit loads of its
// columns of B, and 4 * TN FFMAs: the loads issue at a quarter of the FFMA
// rate, so fewer, wider loads keep the FFMA pipe fed.  Weights are (K, N)
// row-major, the Flax layout, transposed once when the model packs them.
// On an H100 this product is bound by shared memory: 12 floats read a step
// for 32 FFMAs, where an SM reads 32 floats a cycle and FFMAs 128, so it
// runs near 30 TFLOP/s; sgemm.cuh's 8 x 8 tile is the core of the merged
// layers and the training backwards, the forwards move to it next (ROADMAP
// B 5), and mma_tile / mma_rows then go.
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

// One BK-deep step of the block product: acc[i][j] += sum_{kk < BK}
// AT[kk * LDA + row_of(i)] * Ws[kk * N + col_of(j)], N = 32 * TN, with AT
// and Ws the step's k-major tiles in shared memory (LDA a multiple of 4).
template <int TN, int LDA = LDT>
__device__ __forceinline__ void mma_tile(float (&acc)[TM][TN], const float* AT, const float* Ws) {
  constexpr int N = 32 * TN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a4 = *reinterpret_cast<const float4*>(AT + kk * LDA + 4 * warp);
    const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
    float b[TN];
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const float4 b4 = *reinterpret_cast<const float4*>(Ws + kk * N + 4 * lane + 128 * g);
      b[4 * g] = b4.x;
      b[4 * g + 1] = b4.y;
      b[4 * g + 2] = b4.z;
      b[4 * g + 3] = b4.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_{k < K} AT[k * LDT + row_of(i)] * W[k * ldw + col_of(j)]
//
// AT: the block's rows k-major in shared memory, zero for k in
// [K, round_up(K, BK)).  W: global, 16-byte aligned, row stride ldw a
// multiple of 4; columns >= ncols (a multiple of 4) read as 0.
// Ws: shared scratch of BK * 32 * TN floats.  Ends with a barrier, so the
// caller may overwrite AT and Ws right after.
template <int TN>
__device__ __forceinline__ void mma_rows(float (&acc)[TM][TN], const float* AT, int K,
                                         const float* __restrict__ W, int ldw, int ncols,
                                         float* Ws) {
  static_assert(TN % 4 == 0, "a lane holds whole float4 column groups");
  constexpr int N = 32 * TN, N4 = N / 4;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = threadIdx.x; idx < BK * N4; idx += NT) {
      int kk = idx / N4, c = 4 * (idx - kk * N4);
      int k = k0 + kk;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < K && c < ncols) v = __ldg(reinterpret_cast<const float4*>(W + (size_t)k * ldw + c));
      *reinterpret_cast<float4*>(Ws + kk * N + c) = v;
    }
    __syncthreads();
    mma_tile<TN>(acc, AT + k0 * LDT, Ws);
    __syncthreads();
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
