// The int8 dense layer of int8 serving: dynamic per-row quantization of the
// activations, an int8 x int8 -> int32 product against weights quantized
// per output column, dequantization and bias, in one launch.
//
// Replaces keypoints_interpolation_transformer_tpu/ops/pallas/
// int8_matmul.py::_kernel:
//     s = max(max_k |x[r, k]|, 1e-12) * (1 / 127)            (per row)
//     xq = clip(rint(x * (1 / s)), -127, 127)
//     y = float(xq Wq) * s * w_scale + b
// with Wq (N, K) int8 in torch's Linear layout and w_scale (N) from
// eval/quantize.py (the Dense table's scale form).
//
// What bounds it on an H100: at the shapes serving gives it (K = 108 to
// 256, N = 108 to 768) the bytes: x in and y out in float32 (4 (K + N)
// bytes per row) against 2 K N int8 operations per row, 38 to 96 per byte,
// below the int8 tensor-core balance (about 590 per byte).
// Design: one block per 32 rows x 128 output columns, 256 threads.  A
// warp per row finds the row's absmax; the rows are quantized 64 k at a time
// into shared memory as packed words (k-major, as int8.cuh lays them out),
// the weight tile beside them, and each thread accumulates a 4 x 4 int32
// tile with __dp4a; the int8 activations never reach device memory.  Not
// copied from the TPU kernel: its 512-row blocks and the weight kept whole
// in VMEM.
#include "common.cuh"
#include "int8.cuh"

using namespace kit;

namespace {

constexpr int DN = 128;      // output columns per block (TN = 4)
constexpr int DLD = DN + 4;  // row stride of the staged weight tile

// The word of k = k .. k + 3 of an int8 row (bytes past `left` read as 0);
// a whole aligned word when `aligned`.
__device__ __forceinline__ int load_word(const int8_t* __restrict__ p, int left, bool aligned) {
  if (aligned) return __ldg(reinterpret_cast<const int*>(p));
  uint32_t v = (uint8_t)p[0];
  if (left > 1) v |= (uint32_t)(uint8_t)p[1] << 8;
  if (left > 2) v |= (uint32_t)(uint8_t)p[2] << 16;
  if (left > 3) v |= (uint32_t)(uint8_t)p[3] << 24;
  return (int)v;
}

__global__ void __launch_bounds__(NT)
int8_dense_kernel(const float* __restrict__ x, int M, int K, const int8_t* __restrict__ wq,
                  const float* __restrict__ ws, const float* __restrict__ b, int N,
                  float* __restrict__ y) {
  __shared__ __align__(16) int Aq[KW * LDT];
  __shared__ __align__(16) int Wi[KW * DLD];
  __shared__ float sc[BM], sinv[BM];
  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * DN;
  const int lane = threadIdx.x & 31;
  const bool aligned = (K & 3) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + row_of(i);
    float a = 0.f;
    if (row < M)
      for (int k = lane; k < K; k += 32) a = fmaxf(a, fabsf(x[(size_t)row * K + k]));
    const float s = row_scale(warp_max(a));
    if (lane == 0) {
      sc[row_of(i)] = s;
      sinv[row_of(i)] = 1.f / s;
    }
  }
  __syncthreads();
  int acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  const int words = (K + 3) / 4;
  for (int w0 = 0; w0 < words; w0 += KW) {
    for (int idx = threadIdx.x; idx < KW * BM; idx += NT) {
      const int r = idx / KW, w = idx - r * KW;
      const int row = row0 + r, k = 4 * (w0 + w);
      int val = 0;
      if (row < M && k < K) {
        const float* xr = x + (size_t)row * K + k;
        val = pack4(xr[0], k + 1 < K ? xr[1] : 0.f, k + 2 < K ? xr[2] : 0.f,
                    k + 3 < K ? xr[3] : 0.f, sinv[r]);
      }
      Aq[w * LDT + r] = val;
    }
    for (int idx = threadIdx.x; idx < KW * DN; idx += NT) {
      const int c = idx / KW, w = idx - c * KW;
      const int col = n0 + c, k = 4 * (w0 + w);
      Wi[w * DLD + c] =
          (col < N && k < K) ? load_word(wq + (size_t)col * K + k, K - k, aligned) : 0;
    }
    __syncthreads();
    imma_tile<4>(acc, Aq, Wi, DLD, min(KW, words - w0));
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + row_of(i);
    if (row >= M) continue;
    const float s = sc[row_of(i)];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + col_of(j);
      if (col >= N) continue;
      float v = dequant(acc[i][j], s, __ldg(ws + col));
      if (b != nullptr) v = __fadd_rn(v, __ldg(b + col));
      y[(size_t)row * N + col] = v;
    }
  }
}

}  // namespace

// x (M, K) -> y (M, N): wq (N, K) int8, w_scale (N), bias (N) or null.
extern "C" int kit_int8_dense(const void* x, int M, int K, const void* wq, const void* w_scale,
                              const void* bias, int N, void* y, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((M + BM - 1) / BM, (N + DN - 1) / DN);
  int8_dense_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)x, M, K, (const int8_t*)wq, (const float*)w_scale, (const float*)bias, N,
      (float*)y);
  return (int)cudaGetLastError();
}
