// Pre-stream chains and post head of the KeypointCompleter, one launch each.
//
// Replaces keypoints_interpolation_transformer_tpu/ops/pallas/pointwise.py:
//   _pre_kernel        n = token_norm(e) [+ token_norm(e)] + (pe + learned);
//                      s = fc3(fc1(n) * sigmoid(fc2(n))), from an embedding
//                      e that is already computed (the JAX package reaches
//                      it only with its embedding kernel switched off; no
//                      route of the port's model takes it)
//   _pre_embed_kernel  e = x Wemb + bemb;  n = token_norm(e) [+ token_norm(e)]
//                      + (pe + learned);  s = fc3(fc1(n) * sigmoid(fc2(n)))
//                      (optionally also emits e, the filled stream's
//                      post-head residual)
//   _post_kernel       s = SwiGLU(d);  z = token_norm(s + filled_emb);
//                      z = z * sigmoid(z);  out = z Wh + bh
//
// What bounds it on an H100: float32 FFMA work, 0.45 MFLOP per token for the
// pre chain at D = 256 (14.7 GFLOP per stream at B = 256, T = 128),
// against 2 KB of activations in and out per token.  The weights (0.9 MB)
// are re-read by every block from L2.  Design: one block owns 32 token rows
// for the whole chain, so the embedding, the norm, both SwiGLU
// intermediates and the gate never leave shared memory or registers; only x
// comes in and s (and e) go out.  fc1 and fc2 run as ONE product against
// the packed [W1 | W2] (D, 2D) weight so each thread holds x1 and x2 of the
// same column and gates them in registers.  The 108 -> 128 lane padding of
// the TPU kernel is not copied: the 108-deep contraction is zero-padded only
// to the 16-deep weight tile.
#include "common.cuh"

using namespace kit;

namespace {

// s = (g W3 + b3) with g = x1 * sigmoid(x2), [x1 | x2] = A W12 + b12.
// AT holds the block's D-wide rows k-major and is overwritten with g.
template <int TN>
__device__ __forceinline__ void swiglu_rows(float (&s)[TM][TN], float* AT, float* Ws,
                                            const float* __restrict__ w12,
                                            const float* __restrict__ b12,
                                            const float* __restrict__ w3,
                                            const float* __restrict__ b3) {
  constexpr int D = 32 * TN;
  float h[TM][2 * TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 2 * TN; ++j) h[i][j] = 0.f;
  mma_rows<2 * TN>(h, AT, D, w12, 2 * D, 2 * D, Ws);
  float g[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int c = col_of(j);
      float x1 = h[i][j] + __ldg(b12 + c);
      float x2 = h[i][j + TN] + __ldg(b12 + D + c);
      g[i][j] = x1 * sigmoidf(x2);
    }
  put_rows<TN>(AT, g);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
  mma_rows<TN>(s, AT, D, w3, D, D, Ws);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) s[i][j] += __ldg(b3 + col_of(j));
}

template <int TN>
__global__ void __launch_bounds__(NT)
pre_embed_kernel(const float* __restrict__ x, int M, int T, int F,
                 const float* __restrict__ wemb, const float* __restrict__ bemb,
                 const float* __restrict__ pe, const float* __restrict__ w12,
                 const float* __restrict__ b12, const float* __restrict__ w3,
                 const float* __restrict__ b3, float* __restrict__ out,
                 float* __restrict__ emb, int pe_residual) {
  constexpr int D = 32 * TN;
  extern __shared__ __align__(16) float smem[];
  float* AT = smem;            // D x LDT, k-major rows
  float* Ws = smem + D * LDT;  // BK x 2D
  const int row0 = blockIdx.x * BM;

  stage_rows(AT, x, F, row0, M, F);  // round_up(F, BK) <= D, checked by the host
  __syncthreads();
  float e[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) e[i][j] = 0.f;
  mma_rows<TN>(e, AT, F, wemb, D, D, Ws);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) e[i][j] += __ldg(bemb + col_of(j));
  if (emb != nullptr) store_rows<TN>(emb, D, D, row0, M, e);

  row_norm<TN>(e);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int t = (row0 + row_of(i)) % T;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float p = __ldg(pe + (size_t)t * D + col_of(j));
      e[i][j] = pe_residual ? (e[i][j] + e[i][j]) + p : e[i][j] + p;
    }
  }
  put_rows<TN>(AT, e);
  __syncthreads();
  float s[TM][TN];
  swiglu_rows<TN>(s, AT, Ws, w12, b12, w3, b3);
  store_rows<TN>(out, D, D, row0, M, s);
}

// The pre-stream chain from the embedding e (M, D): the second half of
// pre_embed_kernel.
template <int TN>
__global__ void __launch_bounds__(NT)
pre_stream_kernel(const float* __restrict__ e_in, int M, int T, const float* __restrict__ pe,
                  const float* __restrict__ w12, const float* __restrict__ b12,
                  const float* __restrict__ w3, const float* __restrict__ b3,
                  float* __restrict__ out, int pe_residual) {
  constexpr int D = 32 * TN;
  extern __shared__ __align__(16) float smem[];
  float* AT = smem;            // D x LDT, k-major rows
  float* Ws = smem + D * LDT;  // BK x 2D
  const int row0 = blockIdx.x * BM;

  stage_rows(AT, e_in, D, row0, M, D);
  __syncthreads();
  float e[TM][TN];
  get_rows<TN>(e, AT);
  row_norm<TN>(e);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int t = (row0 + row_of(i)) % T;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float p = __ldg(pe + (size_t)t * D + col_of(j));
      e[i][j] = pe_residual ? (e[i][j] + e[i][j]) + p : e[i][j] + p;
    }
  }
  put_rows<TN>(AT, e);  // each thread rewrites only what it read
  __syncthreads();
  float s[TM][TN];
  swiglu_rows<TN>(s, AT, Ws, w12, b12, w3, b3);
  store_rows<TN>(out, D, D, row0, M, s);
}

template <int TN>
__global__ void __launch_bounds__(NT)
post_head_kernel(const float* __restrict__ d, const float* __restrict__ f, int M,
                 const float* __restrict__ w12, const float* __restrict__ b12,
                 const float* __restrict__ w3, const float* __restrict__ b3,
                 const float* __restrict__ wh, const float* __restrict__ bh, int F,
                 float* __restrict__ out) {
  constexpr int D = 32 * TN;
  extern __shared__ __align__(16) float smem[];
  float* AT = smem;            // D x LDT, k-major rows
  float* Ws = smem + D * LDT;  // BK x 2D
  const int row0 = blockIdx.x * BM;

  stage_rows(AT, d, D, row0, M, D);
  __syncthreads();
  float z[TM][TN];
  swiglu_rows<TN>(z, AT, Ws, w12, b12, w3, b3);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int row = row0 + row_of(i);
#pragma unroll
    for (int j = 0; j < TN; ++j)
      z[i][j] += row < M ? __ldg(f + (size_t)row * D + col_of(j)) : 0.f;
  }
  row_norm<TN>(z);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) z[i][j] = z[i][j] * sigmoidf(z[i][j]);
  put_rows<TN>(AT, z);  // swiglu_rows ended on a barrier: AT is free
  __syncthreads();
  float o[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) o[i][j] = 0.f;
  mma_rows<TN>(o, AT, D, wh, F, F, Ws);  // F <= D output columns
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int c = col_of(j);
      o[i][j] += c < F ? __ldg(bh + c) : 0.f;
    }
  store_rows<TN>(out, F, F, row0, M, o);
}

template <int TN>
int launch_pre(const float* x, int M, int T, int F, const float* wemb, const float* bemb,
               const float* pe, const float* w12, const float* b12, const float* w3,
               const float* b3, float* out, float* emb, int pe_residual, cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int smem = (D * LDT + BK * 2 * D) * sizeof(float);
  static bool ready = false;
  cudaError_t e = allow_smem(pre_embed_kernel<TN>, smem, ready);
  if (e != cudaSuccess) return (int)e;
  pre_embed_kernel<TN><<<(M + BM - 1) / BM, NT, smem, st>>>(
      x, M, T, F, wemb, bemb, pe, w12, b12, w3, b3, out, emb, pe_residual);
  return (int)cudaGetLastError();
}

template <int TN>
int launch_pre_stream(const float* e, int M, int T, const float* pe, const float* w12,
                      const float* b12, const float* w3, const float* b3, float* out,
                      int pe_residual, cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int smem = (D * LDT + BK * 2 * D) * sizeof(float);
  static bool ready = false;
  cudaError_t err = allow_smem(pre_stream_kernel<TN>, smem, ready);
  if (err != cudaSuccess) return (int)err;
  pre_stream_kernel<TN><<<(M + BM - 1) / BM, NT, smem, st>>>(e, M, T, pe, w12, b12, w3, b3, out,
                                                            pe_residual);
  return (int)cudaGetLastError();
}

template <int TN>
int launch_post(const float* d, const float* f, int M, const float* w12, const float* b12,
                const float* w3, const float* b3, const float* wh, const float* bh, int F,
                float* out, cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int smem = (D * LDT + BK * 2 * D) * sizeof(float);
  static bool ready = false;
  cudaError_t e = allow_smem(post_head_kernel<TN>, smem, ready);
  if (e != cudaSuccess) return (int)e;
  post_head_kernel<TN><<<(M + BM - 1) / BM, NT, smem, st>>>(d, f, M, w12, b12, w3, b3, wh, bh,
                                                           F, out);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, F) -> out (M, D) [and emb (M, D) when emb is not null]; pe (T, D)
// holds the sinusoidal table plus the learned position vector; row m is
// position m % T.  D is 128, 256, 384 or 512; F <= D is a multiple of 4.
extern "C" int kit_pre_embed(const void* x, int M, int T, int F, int D, const void* wemb,
                             const void* bemb, const void* pe, const void* w12, const void* b12,
                             const void* w3, const void* b3, void* out, void* emb,
                             int pe_residual, void* stream) {
  auto p = [](const void* v) { return (const float*)v; };
  return by_width(D, [&](auto tn) {
    return launch_pre<decltype(tn)::value>(p(x), M, T, F, p(wemb), p(bemb), p(pe), p(w12),
                                           p(b12), p(w3), p(b3), (float*)out, (float*)emb,
                                           pe_residual, (cudaStream_t)stream);
  });
}

// e (M, D) -> out (M, D): the pre-stream chain on an embedding; pe as
// kit_pre_embed takes it.  D is 128, 256, 384 or 512.
extern "C" int kit_pre_stream(const void* e, int M, int T, int D, const void* pe,
                              const void* w12, const void* b12, const void* w3, const void* b3,
                              void* out, int pe_residual, void* stream) {
  auto p = [](const void* v) { return (const float*)v; };
  return by_width(D, [&](auto tn) {
    return launch_pre_stream<decltype(tn)::value>(p(e), M, T, p(pe), p(w12), p(b12), p(w3),
                                                  p(b3), (float*)out, pe_residual,
                                                  (cudaStream_t)stream);
  });
}

// d, f (M, D) -> out (M, F); F <= D is a multiple of 4.
extern "C" int kit_post_head(const void* d, const void* f, int M, int D, const void* w12,
                             const void* b12, const void* w3, const void* b3, const void* wh,
                             const void* bh, int F, void* out, void* stream) {
  auto p = [](const void* v) { return (const float*)v; };
  return by_width(D, [&](auto tn) {
    return launch_post<decltype(tn)::value>(p(d), p(f), M, p(w12), p(b12), p(w3), p(b3), p(wh),
                                            p(bh), F, (float*)out, (cudaStream_t)stream);
  });
}
