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
// pre chain at D = 256 (14.7 GFLOP per stream at B = 256, T = 128), against
// 2 KB of activations in and out per token; the weights (0.9 MB) stay in L2.
// Design: one block owns a tile of row_tile(D) token rows (64 up to D = 256,
// 32 above; 32 also where the 64-row tiles would not fill half the card,
// sgemm.cuh's rows_fill, as the per-sublayer forwards choose) for the whole
// chain, so the embedding, the norm, both SwiGLU intermediates and the gate
// never leave shared memory or registers; only x comes in and s (and e) go
// out.  Every product runs on sgemm.cuh's core, as the merged layers' do:
// an 8 x 8 sum tile a thread (half the shared memory reads per FFMA of the
// 4 x 8 tile that the first form of these kernels used, on 32-row tiles),
// and the weights streamed through a ring of cp.async tiles chained from
// one product into the next (Wemb, W1, W2, W3), each tile serving the
// block's 64 rows: half the L2 traffic of 32 rows a tile.  fc1 and fc2
// run as two D-wide products from the packed [W1 | W2] (D, 2D) weight: x1
// + b1 goes to shared memory, and the gate x1 * sigmoid(x2 + b2) is taken
// where each thread holds x2 after the second.
// The row steps (token_norm, the positional sum, swish) take a row in one
// warp, reached through shared memory.  The head reads its F <= 128 output
// columns as one 128-wide product, not a D-wide one.  The 108 -> 128 lane
// padding of the TPU kernel is not copied: the 108-deep contraction is
// zero-padded only to the 16-deep weight tile.
#include "common.cuh"
#include "sgemm.cuh"

using namespace kit;

namespace {

// The tile of a width's build: Xs and Hs (D x LDA k-major each), then the
// weight ring; BM rows a block (row_tile(D) where those tiles fill half the
// card, else 32: more blocks for a short batch).
template <int TN, int ROWS>
struct Geo {
  static constexpr int D = 32 * TN;
  static constexpr int BM = ROWS;
  static constexpr int LDA = BM + 4;  // keeps 16-byte rows and 4 LDA = 16 mod 32
  static constexpr int STAGES = ring_stages(D);
  static constexpr int DEPTH = BK;
  static constexpr int RM = BM / 8;   // rows a warp in the row layout
  static constexpr int HN = 128;      // the head's columns a product
  static constexpr int SMEM = (2 * D * LDA + STAGES * DEPTH * D) * (int)sizeof(float);
  using Acc = float[BM / 8][TN];
  using WRing = Ring<D, DEPTH, STAGES>;
  using HRing = Ring<HN, DEPTH, STAGES>;
};

// AT[c * LDA + r] = x[(row0 + r) * F + c] for r < BM, c < FP (F rounded
// up to the 16-deep weight tile), 0 for rows >= M and columns >= F: the
// frames' F (a multiple of 4) need not be a multiple of 8, as
// stage_kmajor's K must.
template <int BM, int LDA>
__device__ __forceinline__ void stage_frames(float* AT, const float* __restrict__ x, int F,
                                             int row0, int M) {
  const int q = round_up(F, BK) / 4;  // float4 groups a row
  for (int idx = threadIdx.x; idx < BM * q; idx += NT) {
    const int r = idx / q, c = 4 * (idx - r * q), row = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < M && c < F) v = __ldg(reinterpret_cast<const float4*>(x + (size_t)row * F + c));
    AT[c * LDA + r] = v.x;
    AT[(c + 1) * LDA + r] = v.y;
    AT[(c + 2) * LDA + r] = v.z;
    AT[(c + 3) * LDA + r] = v.w;
  }
}

// acc += AT cur (block_mma), cur's tiles already in flight if primed;
// next, if it can chain, loads from cur's last steps on.  Returns whether
// next is primed.
template <int TN, int ROWS>
__device__ __forceinline__ bool mma(typename Geo<TN, ROWS>::Acc& acc, const float* AT,
                                    const Wt& cur, const Wt& next,
                                    typename Geo<TN, ROWS>::WRing& ring, bool primed) {
  using G = Geo<TN, ROWS>;
  const Wt nx = G::WRing::chainable(next) ? next : Wt{};
  if (!primed) ring.start(cur, nx);
  block_mma<G::BM, G::D, G::LDA, G::DEPTH, G::STAGES>(acc, AT, cur, nx, ring);
  return nx.W != nullptr;
}

// s = g W3 + b3 with g = (n W1 + b1) * sigmoid(n W2 + b2), n k-major in
// Xs (W1's tiles in flight when primed); Hs takes x1 + b1, then g.  Ends
// with a barrier and nothing in flight: Xs, Hs and the ring are free.
template <int TN, int ROWS>
__device__ __forceinline__ void swiglu(typename Geo<TN, ROWS>::Acc& s, const float* Xs,
                                       float* Hs, typename Geo<TN, ROWS>::WRing& ring,
                                       const float* __restrict__ w12,
                                       const float* __restrict__ b12,
                                       const float* __restrict__ w3,
                                       const float* __restrict__ b3, bool primed) {
  using G = Geo<TN, ROWS>;
  using L = Mma<G::BM, G::D>;
  constexpr int D = G::D, BM = G::BM;
  const Wt w1{w12, 2 * D, D, D}, w2{w12 + D, 2 * D, D, D}, w3t{w3, D, D, D};
  zero(s);
  primed = mma<TN, ROWS>(s, Xs, w1, w2, ring, primed);
  g_bias<BM, D>(s, b12);
  g_put<BM, D, G::LDA>(Hs, s);  // x1 + b1
  zero(s);
  primed = mma<TN, ROWS>(s, Xs, w2, w3t, ring, primed);
  // g = x1 * sigmoid(x2 + b2) at this thread's own positions of Hs
#pragma unroll
  for (int j = 0; j < L::CT; ++j) {
    const int c = L::col(j);
    const float b2 = __ldg(b12 + D + c);
#pragma unroll
    for (int q = 0; q < L::RT / 4; ++q) {
      float4* h = reinterpret_cast<float4*>(Hs + c * G::LDA + L::row(4 * q));
      const float4 x1 = *h;
      *h = make_float4(x1.x * sigmoidf(s[4 * q][j] + b2), x1.y * sigmoidf(s[4 * q + 1][j] + b2),
                       x1.z * sigmoidf(s[4 * q + 2][j] + b2),
                       x1.w * sigmoidf(s[4 * q + 3][j] + b2));
    }
  }
  __syncthreads();
  zero(s);
  mma<TN, ROWS>(s, Hs, w3t, Wt{}, ring, primed);
  g_bias<BM, D>(s, b3);
}

// The row layout's n = token_norm(v) [+ token_norm(v)] + pe[row % T], back
// into Xs (each thread rewrites only what it read), then a barrier.
template <int TN, int ROWS>
__device__ __forceinline__ void norm_pe(float (&v)[Geo<TN, ROWS>::RM][TN], float* Xs,
                                        const float* __restrict__ pe, int row0, int T,
                                        int pe_residual) {
  using G = Geo<TN, ROWS>;
  constexpr int D = G::D;
  row_norm<TN>(v);
#pragma unroll
  for (int i = 0; i < G::RM; ++i) {
    const int t = (row0 + row_of<G::RM>(i)) % T;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float p = __ldg(pe + (size_t)t * D + col_of(j));
      v[i][j] = pe_residual ? (v[i][j] + v[i][j]) + p : v[i][j] + p;
    }
  }
  put_rows<TN, G::LDA>(Xs, v);
  __syncthreads();
}

template <int TN, int ROWS>
__global__ void __launch_bounds__(NT, 1)
pre_embed_kernel(const float* __restrict__ x, int M, int T, int F,
                 const float* __restrict__ wemb, const float* __restrict__ bemb,
                 const float* __restrict__ pe, const float* __restrict__ w12,
                 const float* __restrict__ b12, const float* __restrict__ w3,
                 const float* __restrict__ b3, float* __restrict__ out,
                 float* __restrict__ emb, int pe_residual) {
  using G = Geo<TN, ROWS>;
  constexpr int D = G::D, BM = G::BM;
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;
  float* Hs = smem + D * G::LDA;
  typename G::WRing ring{smem + 2 * D * G::LDA, 0};
  const int row0 = blockIdx.x * BM;
  const Wt we{wemb, D, D, F}, w1{w12, 2 * D, D, D};
  ring.start(we, w1);  // in flight while x stages
  stage_frames<BM, G::LDA>(Xs, x, F, row0, M);
  __syncthreads();
  typename G::Acc acc;
  zero(acc);
  mma<TN, ROWS>(acc, Xs, we, w1, ring, true);
  g_bias<BM, D>(acc, bemb);
  g_put<BM, D, G::LDA>(Xs, acc);  // to the row layout (Xs is free)
  __syncthreads();
  float v[G::RM][TN];
  get_rows<TN, G::LDA>(v, Xs);
  if (emb != nullptr) store_rows<TN>(emb, D, D, row0, M, v);
  norm_pe<TN, ROWS>(v, Xs, pe, row0, T, pe_residual);
  swiglu<TN, ROWS>(acc, Xs, Hs, ring, w12, b12, w3, b3, true);
  g_store<BM, D>(out, D, row0, M, acc);
}

// The pre-stream chain from the embedding e (M, D): the second half of
// pre_embed_kernel.
template <int TN, int ROWS>
__global__ void __launch_bounds__(NT, 1)
pre_stream_kernel(const float* __restrict__ e_in, int M, int T, const float* __restrict__ pe,
                  const float* __restrict__ w12, const float* __restrict__ b12,
                  const float* __restrict__ w3, const float* __restrict__ b3,
                  float* __restrict__ out, int pe_residual) {
  using G = Geo<TN, ROWS>;
  constexpr int D = G::D, BM = G::BM;
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;
  float* Hs = smem + D * G::LDA;
  typename G::WRing ring{smem + 2 * D * G::LDA, 0};
  const int row0 = blockIdx.x * BM;
  ring.start(Wt{w12, 2 * D, D, D}, Wt{w12 + D, 2 * D, D, D});
  stage_kmajor<BM, G::LDA>(Xs, e_in, D, row0, M, D);
  __syncthreads();
  float v[G::RM][TN];
  get_rows<TN, G::LDA>(v, Xs);
  norm_pe<TN, ROWS>(v, Xs, pe, row0, T, pe_residual);
  typename G::Acc acc;
  swiglu<TN, ROWS>(acc, Xs, Hs, ring, w12, b12, w3, b3, true);
  g_store<BM, D>(out, D, row0, M, acc);
}

template <int TN, int ROWS>
__global__ void __launch_bounds__(NT, 1)
post_head_kernel(const float* __restrict__ d, const float* __restrict__ f, int M,
                 const float* __restrict__ w12, const float* __restrict__ b12,
                 const float* __restrict__ w3, const float* __restrict__ b3,
                 const float* __restrict__ wh, const float* __restrict__ bh, int F,
                 float* __restrict__ out) {
  using G = Geo<TN, ROWS>;
  using L = Mma<G::BM, G::D>;
  using H = Mma<G::BM, G::HN>;
  constexpr int D = G::D, BM = G::BM;
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;
  float* Hs = smem + D * G::LDA;
  typename G::WRing ring{smem + 2 * D * G::LDA, 0};
  const int row0 = blockIdx.x * BM;
  ring.start(Wt{w12, 2 * D, D, D}, Wt{w12 + D, 2 * D, D, D});
  stage_kmajor<BM, G::LDA>(Xs, d, D, row0, M, D);
  __syncthreads();
  typename G::Acc z;
  swiglu<TN, ROWS>(z, Xs, Hs, ring, w12, b12, w3, b3, true);
#pragma unroll
  for (int i = 0; i < L::RT; ++i) {
    const int row = row0 + L::row(i);
#pragma unroll
    for (int h = 0; h < L::CT / 4; ++h) {
      float4 fv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < M) fv = __ldg(reinterpret_cast<const float4*>(f + (size_t)row * D + L::col(4 * h)));
      z[i][4 * h] += fv.x;
      z[i][4 * h + 1] += fv.y;
      z[i][4 * h + 2] += fv.z;
      z[i][4 * h + 3] += fv.w;
    }
  }
  g_put<BM, D, G::LDA>(Xs, z);  // to the row layout (Xs is free)
  __syncthreads();
  {
    float v[G::RM][TN];
    get_rows<TN, G::LDA>(v, Xs);
    row_norm<TN>(v);
#pragma unroll
    for (int i = 0; i < G::RM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) v[i][j] = v[i][j] * sigmoidf(v[i][j]);
    put_rows<TN, G::LDA>(Xs, v);
  }
  __syncthreads();
  // out = z Wh + bh, 128 output columns a product (the ring is free)
  typename G::HRing hr{ring.buf, 0};
  for (int n0 = 0; n0 < F; n0 += G::HN) {
    const Wt w{wh + n0, F, min(G::HN, F - n0), D};
    float o[BM / 8][G::HN / 32];
    zero(o);
    hr.start(w, Wt{});
    block_mma<BM, G::HN, G::LDA, G::DEPTH, G::STAGES>(o, Xs, w, Wt{}, hr);
    const int c = n0 + H::col(0);
    if (c >= F) continue;  // F is a multiple of 4: the thread's 4 columns are in or out
    const float4 b = __ldg(reinterpret_cast<const float4*>(bh + c));
#pragma unroll
    for (int i = 0; i < H::RT; ++i) {
      const int row = row0 + H::row(i);
      if (row < M)
        *reinterpret_cast<float4*>(out + (size_t)row * F + c) =
            make_float4(o[i][0] + b.x, o[i][1] + b.y, o[i][2] + b.z, o[i][3] + b.w);
    }
  }
}

template <int TN, int BM>
int launch_pre(const float* x, int M, int T, int F, const float* wemb, const float* bemb,
               const float* pe, const float* w12, const float* b12, const float* w3,
               const float* b3, float* out, float* emb, int pe_residual, cudaStream_t st) {
  using G = Geo<TN, BM>;
  static bool done = false;
  cudaError_t e = allow_smem(pre_embed_kernel<TN, BM>, G::SMEM, done);
  if (e != cudaSuccess) return (int)e;
  pre_embed_kernel<TN, BM><<<(M + BM - 1) / BM, NT, G::SMEM, st>>>(
      x, M, T, F, wemb, bemb, pe, w12, b12, w3, b3, out, emb, pe_residual);
  return (int)cudaGetLastError();
}

template <int TN, int BM>
int launch_pre_stream(const float* e, int M, int T, const float* pe, const float* w12,
                      const float* b12, const float* w3, const float* b3, float* out,
                      int pe_residual, cudaStream_t st) {
  using G = Geo<TN, BM>;
  static bool done = false;
  cudaError_t err = allow_smem(pre_stream_kernel<TN, BM>, G::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  pre_stream_kernel<TN, BM><<<(M + BM - 1) / BM, NT, G::SMEM, st>>>(e, M, T, pe, w12, b12, w3,
                                                                    b3, out, pe_residual);
  return (int)cudaGetLastError();
}

template <int TN, int BM>
int launch_post(const float* d, const float* f, int M, const float* w12, const float* b12,
                const float* w3, const float* b3, const float* wh, const float* bh, int F,
                float* out, cudaStream_t st) {
  using G = Geo<TN, BM>;
  static bool done = false;
  cudaError_t e = allow_smem(post_head_kernel<TN, BM>, G::SMEM, done);
  if (e != cudaSuccess) return (int)e;
  post_head_kernel<TN, BM><<<(M + BM - 1) / BM, NT, G::SMEM, st>>>(d, f, M, w12, b12, w3, b3,
                                                                  wh, bh, F, out);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, TN>, std::integral_constant<int, BM>) for
// the kernel width D and M rows: BM = row_tile(D) where those tiles fill
// half the card (rows_fill), else 32 (more blocks for a short batch).
template <typename Fn>
int by_tile(int D, int M, Fn&& fn) {
  return by_width(D, [&](auto tn) {
    constexpr int TN = decltype(tn)::value, BIG = row_tile(32 * TN);
    return rows_fill(M, 32 * TN) ? fn(tn, std::integral_constant<int, BIG>{})
                                 : fn(tn, std::integral_constant<int, 32>{});
  });
}

}  // namespace

// x (M, F) -> out (M, D) [and emb (M, D) when emb is not null]; pe (T, D)
// holds the sinusoidal table plus the learned position vector; row m is
// position m % T.  D is 128, 256, 384 or 512; F <= D is a multiple of 4.
extern "C" int kit_pre_embed(const void* x, int M, int T, int F, int D, const void* wemb,
                             const void* bemb, const void* pe, const void* w12, const void* b12,
                             const void* w3, const void* b3, void* out, void* emb,
                             int pe_residual, void* stream) {
  if (M <= 0) return 0;
  auto p = [](const void* v) { return (const float*)v; };
  return by_tile(D, M, [&](auto tn, auto bm) {
    return launch_pre<decltype(tn)::value, decltype(bm)::value>(
        p(x), M, T, F, p(wemb), p(bemb), p(pe), p(w12), p(b12), p(w3), p(b3), (float*)out,
        (float*)emb, pe_residual, (cudaStream_t)stream);
  });
}

// e (M, D) -> out (M, D): the pre-stream chain on an embedding; pe as
// kit_pre_embed takes it.  D is 128, 256, 384 or 512.
extern "C" int kit_pre_stream(const void* e, int M, int T, int D, const void* pe,
                              const void* w12, const void* b12, const void* w3, const void* b3,
                              void* out, int pe_residual, void* stream) {
  if (M <= 0) return 0;
  auto p = [](const void* v) { return (const float*)v; };
  return by_tile(D, M, [&](auto tn, auto bm) {
    return launch_pre_stream<decltype(tn)::value, decltype(bm)::value>(
        p(e), M, T, p(pe), p(w12), p(b12), p(w3), p(b3), (float*)out, pe_residual,
        (cudaStream_t)stream);
  });
}

// d, f (M, D) -> out (M, F); F <= D is a multiple of 4.
extern "C" int kit_post_head(const void* d, const void* f, int M, int D, const void* w12,
                             const void* b12, const void* w3, const void* b3, const void* wh,
                             const void* bh, int F, void* out, void* stream) {
  if (M <= 0) return 0;
  auto p = [](const void* v) { return (const float*)v; };
  return by_tile(D, M, [&](auto tn, auto bm) {
    return launch_post<decltype(tn)::value, decltype(bm)::value>(
        p(d), p(f), M, p(w12), p(b12), p(w3), p(b3), p(wh), p(bh), F, (float*)out,
        (cudaStream_t)stream);
  });
}
