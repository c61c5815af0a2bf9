// The feed-forward sublayer of the transformer, one launch.
//
// Replaces keypoints_interpolation_transformer_tpu/ops/pallas/ffn.py::
// _kernel_single (the float32 mode; _kernel_split is the bf16x3 mode of the
// same math):
//     x1 = LN1(r) if pre_ln else r
//     u  = x1 W1 + b1;  h = gelu(u) (exact erf);  z = x1 + (h W2 + b2)
//     y  = LN2(z)
//
// What bounds it on an H100: float32 FFMA work, 2 * 2 * D * FF = 2.1 MFLOP
// per token at D = 256, FF = 2048 (69 GFLOP per call at B = 256, T = 128),
// while only 2 KB per token come in and go out.  The (tokens, FF)
// intermediate would be 268 MB per call if it were written.  Design: one
// block owns 32 token rows; x1 stays in shared memory, the FF axis is walked
// in D-wide chunks, each chunk's u and gelu(u) live in registers and a
// shared tile, and z accumulates in registers across the chunks; LN1 and
// LN2 run over the full row (one warp per row).  Nothing but r and y touch
// device memory.  GELU uses erff: the rational erf of the TPU kernel exists
// only because Mosaic has no erf.
#include "common.cuh"

using namespace kit;

namespace {

template <int TN>
__global__ void __launch_bounds__(NT)
ffn_kernel(const float* __restrict__ r, int M, int FF, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ w2,
           const float* __restrict__ b2, const float* __restrict__ g1,
           const float* __restrict__ be1, const float* __restrict__ g2,
           const float* __restrict__ be2, float* __restrict__ y) {
  constexpr int D = 32 * TN;
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;                // D x LDT: x1, k-major
  float* Hs = smem + D * LDT;      // D x LDT: gelu(u) of one FF chunk
  float* Ws = smem + 2 * D * LDT;  // BK x D
  const int row0 = blockIdx.x * BM;

  stage_rows(Xs, r, D, row0, M, D);
  __syncthreads();
  float v[TM][TN];
  if (g1 != nullptr) {
    get_rows<TN>(v, Xs);
    layer_norm<TN>(v, g1, be1);
    put_rows<TN>(Xs, v);  // each thread rewrites only what it read
    __syncthreads();
  }

  float z[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) z[i][j] = 0.f;
  for (int f0 = 0; f0 < FF; f0 += D) {
    const int fc = min(D, FF - f0);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) v[i][j] = 0.f;
    mma_rows<TN>(v, Xs, D, w1 + f0, FF, fc, Ws);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        int c = col_of(j);
        float u = c < fc ? v[i][j] + __ldg(b1 + f0 + c) : 0.f;
        v[i][j] = 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
      }
    put_rows<TN>(Hs, v);
    __syncthreads();
    mma_rows<TN>(z, Hs, fc, w2 + (size_t)f0 * D, D, D, Ws);
  }
  get_rows<TN>(v, Xs);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) z[i][j] = v[i][j] + (z[i][j] + __ldg(b2 + col_of(j)));
  layer_norm<TN>(z, g2, be2);
  store_rows<TN>(y, D, D, row0, M, z);
}

template <int TN>
int launch(const float* r, int M, int FF, const float* w1, const float* b1, const float* w2,
           const float* b2, const float* g1, const float* be1, const float* g2, const float* be2,
           float* y, cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int smem = (2 * D * LDT + BK * D) * sizeof(float);
  static bool ready = false;
  cudaError_t e = allow_smem(ffn_kernel<TN>, smem, ready);
  if (e != cudaSuccess) return (int)e;
  ffn_kernel<TN><<<(M + BM - 1) / BM, NT, smem, st>>>(r, M, FF, w1, b1, w2, b2, g1, be1, g2, be2,
                                                      y);
  return (int)cudaGetLastError();
}

}  // namespace

// r (M, D) -> y (M, D); w1 (D, FF), w2 (FF, D).  g1, be1 null means no LN1.
// D is 128 or 256.
extern "C" int kit_ffn(const void* r, int M, int D, int FF, const void* w1, const void* b1,
                       const void* w2, const void* b2, const void* g1, const void* be1,
                       const void* g2, const void* be2, void* y, void* stream) {
  auto st = (cudaStream_t)stream;
  auto p = [](const void* v) { return (const float*)v; };
  switch (D) {
    case 128:
      return launch<4>(p(r), M, FF, p(w1), p(b1), p(w2), p(b2), p(g1), p(be1), p(g2), p(be2),
                       (float*)y, st);
    case 256:
      return launch<8>(p(r), M, FF, p(w1), p(b1), p(w2), p(b2), p(g1), p(be1), p(g2), p(be2),
                       (float*)y, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
