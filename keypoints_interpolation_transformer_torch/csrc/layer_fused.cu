// Whole transformer layers, one launch each: the post-LN encoder layer and
// the decoder layer (self-attention + LN1, cross-attention, and the FF tail
// when asked).
//
// Replaces keypoints_interpolation_transformer_tpu/ops/pallas/layer_fused.py
// (the float32 mode, and the encoder's ff_int8 mode):
//   * _enc_kernel (fused_encoder_layer):
//         r = x + MHA(x);  x1 = LN1(r);  y = LN2(x1 + gelu(x1 W1 + b1) W2 + b2)
//     and with ff_int8 (fused_encoder_layer_int8) the FF tail int8 x int8 ->
//     int32 as ffn.cu's int8 kernel runs it (int8.cuh::ff_int8_rows; its GELU
//     rows in per-video scratch); the attention stays float32, as it does
//     in the TPU kernel unless attn_int8 is asked for (not ported).
//   * _dec_kernel (fused_decoder_selfcross):
//         x1 = LN1(x + SA(x));  r = x1 + CA(x1, memory)
//         y = LN3(x2 + gelu(x2 W1 + b1) W2 + b2), x2 = LN2(r)   (with the FF tail)
//         y = r                                                 (without it)
// MHA as in attn_sublayer.cu: q = x Wq + bq, k = m Wk + bk, v = m Wv + bv,
// softmax(q k^T / sqrt(dh) + bias) v per head, out-projection Wo + bo, with
// the bias built from the 1-D (B, T) masks by key_bias (attention.cuh).
// GELU is exact erff; NEG is the finite -1e9, so a row whose keys are all
// blocked averages them and never gives NaN.
//
// What bounds it on an H100: float32 FFMA work.  The encoder layer is
// 2 D (4 D + 2 FF) FLOP per token of products plus 4 H T dh of attention
// (2.75 MFLOP per token at D = 256, FF = 2048, T = 128; 90 GFLOP per call
// at B = 256, 1.35 ms at the 67 TFLOP/s FFMA peak), the decoder layer
// 2 D (8 D + 2 FF) + 8 H T dh (3.4 MFLOP per token, 1.67 ms), against
// 2-3 KB per token in and out and 4-6 MB of weights that stay in the 50 MB
// L2.  Three limits sit under that peak, and the products (sgemm.cuh) meet
// each:
//   * shared-memory bandwidth per FFMA: an 8 x 8 sum tile a thread (rows
//     and columns in float4 groups, lanes 4 x 8 over a 32 x 64 warp tile)
//     reads 16 floats a step of depth 1 for 64 FFMAs, which an SM's 32
//     floats a cycle of shared memory just keep up with (common.cuh's 4 x 8
//     tile read 12 for 32: 1.5 times what its FFMAs could use);
//   * weight bytes from L2 per row: each weight tile serves a 64-row tile
//     (D <= 256; 32 at D = 384, 512), so at B = 256 one encoder call moves
//     about 2.7 GB from L2 rather than 5.4;
//   * exposed load latency: the weight tiles stream through a 3-stage ring
//     (2 at D = 512) of cp.async copies, the next tiles in flight while one
//     is multiplied (across products too), one barrier a step.
// What is left (`layer_probe.py phases`, PERF.md §5): the products at about
// 65 % of the FFMA peak, the attention phase, bound by shared-memory reads
// of its key and value rows (unchanged here), the exact-erf GELU and the
// LayerNorms' hand-offs through shared memory.
// The budget that pays for it: 64 rows x D sums in registers twice in the
// FF tail (its output and one GELU chunk: 128 registers a thread at
// D = 256), so one block of 256 threads an SM (__launch_bounds__(NT, 1),
// up to 255 registers, no spills) with 94-213 KB of shared memory.
//
// Design.  Nothing of a whole layer fits one SM: at T = 128 a video's q, k
// and v are 384 KB, its FF hidden 1 MB.  Here a thread-block cluster of
// cl blocks of 256 threads owns one video and walks the layer's phases in
// order, each phase's work split over the cluster's blocks, with a
// cluster barrier between phases; what must outlive a phase goes to
// per-video scratch in device memory (the wrapper allocates it) and is
// read back through L2 (ld.global.cg), so no intermediate returns to
// PyTorch between the sublayers:
//   1. projections, one (row tile, D-wide column part) product per step of
//      a block: q, k, v (and, in the decoder, the cross-attention k, v of
//      the memory); written to scratch;
//   2. attention: each thread takes one (head, query) of the video at a
//      time (the block's share of the H T of them, in rounds of 256); keys
//      and values of the block's heads stream through shared memory 32
//      keys at a time, the online softmax of attention.cuh folds them;
//      writes a (T, D) to scratch;
//   3. per row tile: the out-projection and residual, LN1, then the FF tail
//      (x1 in shared memory, the FF axis in D-wide chunks with the GELU
//      chunk on chip, LN2); the decoder instead writes x1 and the
//      cross-attention q, runs phase 2 again on them, then the cross
//      out-projection, residual and its FF tail.  The sums reach the
//      LayerNorms' warp-per-row layout through shared memory.  When the
//      cluster has at least two blocks a tile (a small batch: 8 blocks a
//      video at B <= 16, and two 64-row tiles at T = 128), the FF chunks
//      of a tile are split over "parts" blocks: each computes the tile's
//      out-projection and LN1 itself, sums its share of the chunks into
//      per-video scratch, and after a cluster barrier the tile's first
//      block adds the parts in order, then the residual and LN2.
// The wrapper sizes the cluster to about one block per SM over the batch
// (1 to 8 blocks): a batch of 256 videos takes clusters of 1, a single
// video one of 8, so one request is spread over 8 SMs instead of waiting
// on one.  The projections and the phases of step 3 are device functions
// of the width alone, not inlined (ptxas still compiles them into each
// head-width build).
// Not copied from the TPU kernel: the bf16x3 stacked weights, the bb row
// batching and the VMEM budgets (T is free here).
#include <cooperative_groups.h>

#include "attention.cuh"
#include "common.cuh"
#include "int8.cuh"
#include "sgemm.cuh"

using namespace kit;

namespace {

constexpr int KT = 32;  // keys per shared tile (all heads)
constexpr int KC = 16;  // keys per online-softmax chunk

struct Attn {         // one attention sublayer's weights, Flax layout
  const float* wqkv;  // (D, 3D) = [Wq | Wk | Wv]
  const float* bqkv;  // (3D)
  const float* wo;    // (D, D)
  const float* bo;    // (D)
};

struct Bias {         // what one attention's bias is built from
  const float* mask;  // (B, T) or null
  const float* valid; // (B, T) or null: every key valid
  int repeat_inc, add_keypad;
};

struct FeedFwd {      // LN_out(x1 + gelu(x1 W1 + b1) W2 + b2), x1 = LN_in(r)
  const float *w1, *b1, *w2, *b2;  // (D, n), (n), (n, D), (D)
  const float *g_in, *be_in, *g_out, *be_out;
  int n;
  FFInt8 q;  // q.w1q not null: the int8 tail (w1, w2 unused)
  float* h;  // int8 tail: (B, T, n) scratch for the GELU rows
};

struct LayerArgs {
  const float* x;    // (B, T, D)
  const float* mem;  // (B, T, D), decoder only
  float* y;          // (B, T, D)
  float* scratch;    // per video: (base + split) T D floats, see scratch_per_video
  int T, H;
  int n;             // the model's true width (see common.cuh); n / H the head width
  int cl;            // blocks per video: the cluster size
  int parts;         // blocks that share one row tile's FF chunks (1: no split)
  Attn self, cross;
  const float *g1, *be1;  // the decoder's LN1
  Bias sbias, cbias;
  FeedFwd ff;             // ff.w1 and ff.q.w1q null: the decoder without its FF tail
};

// The geometry of a width's build (D = 32 TN): row tile, shared memory
// (Xs and Hs, D x LDA k-major each, then the weight ring; the attention
// phase reuses it for its key and value tiles).
template <int TN>
struct Geo {
  static constexpr int D = 32 * TN;
  static constexpr int BM = row_tile(D);
  static constexpr int LDA = BM + 4;  // keeps 16-byte rows and 4 LDA = 16 mod 32
  static constexpr int STAGES = ring_stages(D);
  static constexpr int DEPTH = BK;    // contraction depth of a weight tile
  static constexpr int RM = BM / 8;   // rows a warp in the LayerNorm layout
  static constexpr int ROWS = 2 * D * LDA + STAGES * DEPTH * D;
  static constexpr int KEYS = 2 * KT * D + 2 * KT;
  static constexpr int SMEM = (ROWS > KEYS ? ROWS : KEYS) * (int)sizeof(float);
  using Acc = float[BM / 8][TN];  // a thread's sums of a BM x D product
  using WRing = Ring<D, DEPTH, STAGES>;
  // the weight ring, after Xs and Hs
  __device__ static WRing ring(float* smem) { return WRing{smem + 2 * D * LDA, 0}; }
};

// Scratch floats per video: the base regions (4 T D in the encoder, 8 T D
// in the decoder) and, with the FF split, one T x D partial sum per part.
__host__ __device__ inline size_t scratch_per_video(bool decoder, int parts, int T, int D) {
  return (size_t)((decoder ? 8 : 4) + (parts > 1 ? parts : 0)) * T * D;
}

// The end of a phase: every block of the video's cluster has written its
// share of scratch (made visible at cluster scope) and freed its shared
// memory.
__device__ __forceinline__ void phase_sync(int cl) {
  if (cl > 1) {
    __threadfence();
    cooperative_groups::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// acc += AT cur (block_mma), cur's tiles already in flight if primed;
// next, if it can chain, loads from cur's last steps on.  Returns whether
// next is primed.
template <int TN>
__device__ __forceinline__ bool mma(typename Geo<TN>::Acc& acc, const float* AT, const Wt& cur,
                                    const Wt& next, typename Geo<TN>::WRing& ring,
                                    bool primed) {
  using G = Geo<TN>;
  const Wt nx = G::WRing::chainable(next) ? next : Wt{};
  if (!primed) ring.start(cur, nx);
  block_mma<G::BM, G::D, G::LDA, G::DEPTH, G::STAGES>(acc, AT, cur, nx, ring);
  return nx.W != nullptr;
}

// dst[:, p D .. (p + 1) D) = src W[:, p D ..] + bias[p D ..] for p < parts,
// over the video's T rows of width D (row strides D and ldd): this block's
// share, a contiguous run of the (row tile, part) products.
template <int TN>
__device__ __noinline__ void project(float* smem, const float* src, int T, const float* W,
                                     int ldw, const float* bias, int parts, float* dst, int ldd,
                                     int rank, int cl) {
  using G = Geo<TN>;
  constexpr int D = G::D, BM = G::BM;
  float* Xs = smem;
  auto ring = G::ring(smem);
  const int total = (T + BM - 1) / BM * parts, per = (total + cl - 1) / cl;
  const int end = min(total, (rank + 1) * per);
  auto weight = [&](int k) {  // the product of run item k
    return k < end ? Wt{W + (k % parts) * D, ldw, D, D} : Wt{};
  };
  int staged = -1;
  bool primed = false;
  for (int k = rank * per; k < end; ++k) {
    const int tile = k / parts, p = k - tile * parts, row0 = tile * BM;
    if (tile != staged) {
      __syncthreads();  // Xs is free
      if (!primed) ring.start(weight(k), weight(k + 1));  // in flight while Xs stages
      primed = true;
      stage_kmajor<BM, G::LDA>(Xs, src, D, row0, T, D);
      __syncthreads();
      staged = tile;
    }
    typename G::Acc acc;
    zero(acc);
    primed = mma<TN>(acc, Xs, weight(k), weight(k + 1), ring, primed);
    g_bias<BM, D>(acc, bias + p * D);
    g_store<BM, D>(dst + p * D, ldd, row0, T, acc);
  }
}

// out[qi, h hd ..] = softmax(q k^T / sqrt(hd) + bias) v for this block's
// share of the (head h, query qi) pairs of video b (a contiguous run of
// item = h T + qi); q, k, v rows of the video with strides ldq and ldkv,
// out (T, D).  Only the heads of the block's items are staged.  The head
// width hd is DH when EXACT, else dh (see attention.cuh).
template <int TN, int DH, bool EXACT>
__device__ void attend(float* smem, const float* q, int ldq, const float* k, const float* v,
                       int ldkv, Bias bias, int b, int T, int H, int dh, float* out, int rank,
                       int cl) {
  constexpr int D = 32 * TN;
  float* Ks = smem;         // KT x D
  float* Vs = Ks + KT * D;  // KT x D
  float* km = Vs + KT * D;  // KT: mask[key]
  float* kv = km + KT;      // KT: valid[key]
  const int hd = EXACT ? DH : dh;
  const float* mask = bias.mask == nullptr ? nullptr : bias.mask + (size_t)b * T;
  const float* valid = bias.valid == nullptr ? nullptr : bias.valid + (size_t)b * T;
  const float scale = 1.f / sqrtf((float)hd);
  const int per = (H * T + cl - 1) / cl;
  const int lo = rank * per, items = min(H * T, lo + per);
  for (int i0 = lo; i0 < items; i0 += NT) {
    const int item = i0 + threadIdx.x;
    const bool active = item < items;
    // the columns of the heads this round's items touch, in whole float4
    // groups
    const int c_lo = i0 / T * hd / 4 * 4;
    const int c_hi = round_up((min(items, i0 + NT) - 1) / T * hd + hd, 4);
    const int h = active ? item / T : i0 / T;
    const int qi = active ? item - h * T : 0;
    float qv[DH], o[DH];
#pragma unroll (EXACT ? DH : 1)
    for (int d = 0; d < hd; ++d) {
      qv[d] = active ? __ldcg(q + (size_t)qi * ldq + h * hd + d) : 0.f;
      o[d] = 0.f;
    }
    float m = -INFINITY, l = 0.f;
    for (int k0 = 0; k0 < T; k0 += KT) {
      __syncthreads();  // the previous tile is consumed
      const int w4 = (c_hi - c_lo) / 4;
      for (int idx = threadIdx.x; idx < KT * w4; idx += NT) {
        const int j = idx / w4, c = c_lo + 4 * (idx - j * w4);
        const int key = k0 + j;
        float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
        if (key < T) {
          kk = __ldcg(reinterpret_cast<const float4*>(k + (size_t)key * ldkv + c));
          vv = __ldcg(reinterpret_cast<const float4*>(v + (size_t)key * ldkv + c));
        }
        *reinterpret_cast<float4*>(Ks + j * D + c) = kk;
        *reinterpret_cast<float4*>(Vs + j * D + c) = vv;
      }
      for (int j = threadIdx.x; j < KT; j += NT) {
        const int key = k0 + j;
        km[j] = (key < T && mask != nullptr) ? mask[key] : 0.f;
        kv[j] = (key < T && valid != nullptr) ? valid[key] : 1.f;
      }
      __syncthreads();
      // every chunk started holds a key < T, so m is finite after the first
      const int nk = min(KT, T - k0);
      for (int c0 = 0; c0 < nk; c0 += KC)
        softmax_chunk<DH, KC, EXACT>(qv, o, m, l, Ks + c0 * D + h * hd, Vs + c0 * D + h * hd,
                                     D, km + c0, kv + c0, qi, k0 + c0, T, bias.repeat_inc,
                                     bias.add_keypad, scale, hd);
    }
    if (active) {
      const float inv = 1.f / l;
      float* dst = out + (size_t)qi * D + h * hd;
      if constexpr (EXACT) {
#pragma unroll
        for (int d = 0; d < DH; d += 4)
          *reinterpret_cast<float4*>(dst + d) =
              make_float4(o[d] * inv, o[d + 1] * inv, o[d + 2] * inv, o[d + 3] * inv);
      } else {
#pragma unroll 1
        for (int d = 0; d < hd; ++d) dst[d] = o[d] * inv;
      }
    }
  }
}

// r = res + (a Wo + bo) for the tile of rows [row0, row0 + BM) of the
// video; a and res (T, D) were written earlier in the launch or are
// inputs.  The caller has made Xs and the ring free.  Wo's first tiles
// load while a stages; next (the product after, or none) as mma takes it.
// Ends with a barrier (block_mma's); returns whether next is primed.
template <int TN>
__device__ __forceinline__ bool out_proj(typename Geo<TN>::Acc& r, float* Xs,
                                         typename Geo<TN>::WRing& ring, const float* a,
                                         const float* res, int row0, int T, const float* wo,
                                         const float* bo, const Wt& next) {
  using G = Geo<TN>;
  using L = Mma<G::BM, G::D>;
  constexpr int D = G::D;
  const Wt w{wo, D, D, D};
  const Wt nx = G::WRing::chainable(next) ? next : Wt{};
  ring.start(w, nx);
  stage_kmajor<G::BM, G::LDA>(Xs, a, D, row0, T, D);
  __syncthreads();
  zero(r);
  const bool primed = mma<TN>(r, Xs, w, nx, ring, true);
#pragma unroll
  for (int i = 0; i < L::RT; ++i) {
    const int row = row0 + L::row(i);
#pragma unroll
    for (int h = 0; h < L::CT / 4; ++h) {
      const int c = L::col(4 * h);
      float4 xr = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < T) xr = __ldcg(reinterpret_cast<const float4*>(res + (size_t)row * D + c));
      r[i][4 * h] = xr.x + (r[i][4 * h] + __ldg(bo + c));
      r[i][4 * h + 1] = xr.y + (r[i][4 * h + 1] + __ldg(bo + c + 1));
      r[i][4 * h + 2] = xr.z + (r[i][4 * h + 2] + __ldg(bo + c + 2));
      r[i][4 * h + 3] = xr.w + (r[i][4 * h + 3] + __ldg(bo + c + 3));
    }
  }
  return primed;
}

// The product layout's sums into the LayerNorm layout (a row in one warp),
// through Xs, which must be free.
template <int TN>
__device__ __forceinline__ void to_rows(float (&v)[Geo<TN>::RM][TN], float* Xs,
                                        const typename Geo<TN>::Acc& acc) {
  using G = Geo<TN>;
  g_put<G::BM, G::D, G::LDA>(Xs, acc);
  __syncthreads();
  get_rows<TN, G::LDA>(v, Xs);
}

// The decoder's step between its attentions, for this block's row tiles:
// x1 = LN1(x + SA(x)) to scratch, and the cross-attention q = x1 Wq + bq.
template <int TN>
__device__ __noinline__ void dec_self_tail(float* smem, const float* a, const float* x,
                                           const Attn self, const Attn cross,
                                           const float* g1, const float* be1, int n,
                                           float* x1, float* q2, int T, int rank, int cl) {
  using G = Geo<TN>;
  constexpr int D = G::D, BM = G::BM;
  float* Xs = smem;
  auto ring = G::ring(smem);
  const Wt wq{cross.wqkv, 3 * D, D, D};
  for (int row0 = rank * BM; row0 < T; row0 += cl * BM) {
    __syncthreads();  // Xs is free
    typename G::Acc acc;
    const bool primed = out_proj<TN>(acc, Xs, ring, a, x, row0, T, self.wo, self.bo, wq);
    float v[G::RM][TN];
    to_rows<TN>(v, Xs, acc);
    layer_norm<TN>(v, g1, be1, n);
    store_rows<TN>(x1, D, D, row0, T, v);
    put_rows<TN, G::LDA>(Xs, v);  // each thread rewrites only what it read
    __syncthreads();
    zero(acc);
    mma<TN>(acc, Xs, wq, Wt{}, ring, primed);
    g_bias<BM, D>(acc, cross.bqkv);
    g_store<BM, D>(q2, D, row0, T, acc);
  }
}

// The int8 FF tail of a tile (int8.cuh ff_int8_rows, on the tile's rows)
// after the out-projection r: LN_in, the tail, LN_out, stored to y.  h:
// the video's (T, n) GELU scratch.
template <int TN>
__device__ __forceinline__ void ff_int8_tile(float* smem, const typename Geo<TN>::Acc& r,
                                             const FeedFwd& ff, int n, int T, int row0,
                                             float* h, float* y) {
  using G = Geo<TN>;
  constexpr int D = G::D;
  float* Xs = smem;
  float v[G::RM][TN];
  to_rows<TN>(v, Xs, r);
  layer_norm<TN>(v, ff.g_in, ff.be_in, n);  // LN_in
  put_rows<TN, G::LDA>(Xs, v);              // each thread rewrites only what it read
  ff_int8_rows<TN, G::RM, G::LDA>(Xs, smem + D * G::LDA, ff.q, h + (size_t)row0 * ff.q.n,
                                   ff.q.n, min(G::BM, T - row0));
  get_rows<TN, G::LDA>(v, Xs);
  layer_norm<TN>(v, ff.g_out, ff.be_out, n);
  store_rows<TN>(y, D, D, row0, T, v);
}

// Hs = gelu(Hs) over the tile's D x BM k-major values, in place (gelu(0) =
// 0 keeps the zeros past a short chunk), then a barrier.  A loop over
// shared memory rather than over the sums in registers: 64 erffs inlined
// a thread lengthened the FF loop's code, and ran slower on an H100
// (PERF.md §6, PR 8).
template <int TN>
__device__ __forceinline__ void gelu_tile(float* Hs) {
  using G = Geo<TN>;
  constexpr int Q = G::BM / 4;  // float4 a k-major row
  for (int e = threadIdx.x; e < G::D * Q; e += NT) {
    float4* p = reinterpret_cast<float4*>(Hs + (e / Q) * G::LDA) + e % Q;
    const float4 u = *p;
    *p = make_float4(gelu(u.x), gelu(u.y), gelu(u.z), gelu(u.w));
  }
  __syncthreads();
}

// The last step of a layer for the tile at row0: r = res + (a Wo + bo);
// without an FF tail y = r; else x1 = LN_in(r), z = the FF chunks [c_lo,
// c_hi) of x1 (gelu(x1 W1 + b1) W2, D-wide chunks, each GELU chunk in Hs),
// and then y = LN_out(x1 + (z + b2)), or, with partial set, z alone to
// partial (the FF split; ff_finish ends the tile).  Xs keeps x1.
template <int TN>
__device__ __noinline__ void ff_tail(float* smem, const float* a, const float* res,
                                     const float* wo, const float* bo, const FeedFwd ff, int n,
                                     int T, int row0, int c_lo, int c_hi, float* partial,
                                     float* h, float* y) {
  using G = Geo<TN>;
  using L = Mma<G::BM, G::D>;
  constexpr int D = G::D, BM = G::BM;
  float* Xs = smem;
  float* Hs = smem + D * G::LDA;
  auto ring = G::ring(smem);
  // the FF products: W1's and W2's D-wide chunk c
  auto w1 = [&](int c) {
    return c < c_hi && ff.w1 != nullptr ? Wt{ff.w1 + c * D, ff.n, min(D, ff.n - c * D), D}
                                        : Wt{};
  };
  auto w2 = [&](int c) { return Wt{ff.w2 + (size_t)c * D * D, D, D, min(D, ff.n - c * D)}; };
  __syncthreads();  // Xs, Hs and the ring are free
  typename G::Acc r;
  bool primed = out_proj<TN>(r, Xs, ring, a, res, row0, T, wo, bo, w1(c_lo));
  if (ff.q.w1q != nullptr) {
    ff_int8_tile<TN>(smem, r, ff, n, T, row0, h, y);
    return;
  }
  if (ff.w1 == nullptr) {
    g_store<BM, D>(y, D, row0, T, r);
    return;
  }
  {
    float v[G::RM][TN];
    to_rows<TN>(v, Xs, r);
    layer_norm<TN>(v, ff.g_in, ff.be_in, n);  // x1 = LN_in(r)
    put_rows<TN, G::LDA>(Xs, v);
  }
  __syncthreads();
  typename G::Acc z;
  zero(z);
  for (int c = c_lo; c < c_hi; ++c) {
    const int f0 = c * D, fc = min(D, ff.n - f0);
    zero(r);
    primed = mma<TN>(r, Xs, w1(c), w2(c), ring, primed);
#pragma unroll
    for (int j = 0; j < L::CT; ++j) {
      const int col = L::col(j);
      const float b1 = col < fc ? __ldg(ff.b1 + f0 + col) : 0.f;
#pragma unroll
      for (int i = 0; i < L::RT; ++i) r[i][j] = col < fc ? r[i][j] + b1 : 0.f;
    }
    g_put<BM, D, G::LDA>(Hs, r);  // x1 W1 + b1; the GELU follows in place
    __syncthreads();
    gelu_tile<TN>(Hs);
    primed = mma<TN>(z, Hs, w2(c), w1(c + 1), ring, primed);
  }
  if (partial != nullptr) {
    g_store<BM, D>(partial, D, row0, T, z);
    return;
  }
  g_get<BM, D, G::LDA>(r, Xs);  // x1, at this thread's positions
#pragma unroll
  for (int j = 0; j < L::CT; ++j) {
    const float b2 = __ldg(ff.b2 + L::col(j));
#pragma unroll
    for (int i = 0; i < L::RT; ++i) r[i][j] = r[i][j] + (z[i][j] + b2);
  }
  g_put<BM, D, G::LDA>(Xs, r);  // each thread rewrites only what it read
  __syncthreads();
  float v[G::RM][TN];
  get_rows<TN, G::LDA>(v, Xs);
  layer_norm<TN>(v, ff.g_out, ff.be_out, n);
  store_rows<TN>(y, D, D, row0, T, v);
}

// The FF split's end for the tile at row0, in the block whose Xs still
// holds its x1: z = the parts' sums added in order, y = LN_out(x1 + (z +
// b2)).
template <int TN>
__device__ __noinline__ void ff_finish(float* smem, const float* partials, int parts,
                                       const FeedFwd ff, int n, int T, int row0, float* y) {
  using G = Geo<TN>;
  constexpr int D = G::D;
  float z[G::RM][TN], v[G::RM][TN];
#pragma unroll
  for (int i = 0; i < G::RM; ++i) {
    const int row = row0 + row_of<G::RM>(i);
#pragma unroll
    for (int j = 0; j < TN; ++j) z[i][j] = 0.f;
    if (row >= T) continue;
    for (int q = 0; q < parts; ++q) {
      const float* src = partials + ((size_t)q * T + row) * D;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float pz = __ldcg(src + col_of(j));
        z[i][j] = q == 0 ? pz : z[i][j] + pz;
      }
    }
  }
  get_rows<TN, G::LDA>(v, smem);  // x1
#pragma unroll
  for (int i = 0; i < G::RM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) v[i][j] = v[i][j] + (z[i][j] + __ldg(ff.b2 + col_of(j)));
  layer_norm<TN>(v, ff.g_out, ff.be_out, n);
  store_rows<TN>(y, D, D, row0, T, v);
}

// Step 3 of a layer over the video's row tiles: r = res + a Wo + bo and
// its FF tail, each tile in one block, or with p.parts > 1 in parts blocks
// (the FF split), then ff_finish after a cluster barrier.
template <int TN>
__device__ __forceinline__ void tails(float* smem, const LayerArgs& p, const float* a,
                                      const float* res, const Attn& at, float* partials,
                                      float* h, float* y, int rank) {
  constexpr int D = Geo<TN>::D, BM = Geo<TN>::BM;
  const int T = p.T, tiles = (T + BM - 1) / BM, chunks = (p.ff.n + D - 1) / D;
  if (p.parts == 1) {
    for (int t = rank; t < tiles; t += p.cl)
      ff_tail<TN>(smem, a, res, at.wo, at.bo, p.ff, p.n, T, t * BM, 0, chunks, nullptr, h, y);
    return;
  }
  const int t = rank / p.parts, q = rank - t * p.parts;
  if (t < tiles)
    ff_tail<TN>(smem, a, res, at.wo, at.bo, p.ff, p.n, T, t * BM, q * chunks / p.parts,
                (q + 1) * chunks / p.parts, partials + (size_t)q * T * D, h, y);
  phase_sync(p.cl);
  if (t < tiles && q == 0) ff_finish<TN>(smem, partials, p.parts, p.ff, p.n, T, t * BM, y);
}

// One encoder layer per cluster of p.cl blocks (one cluster per video).
// Scratch per video: qkv (T, 3D), a (T, D), then the FF split's partials.
template <int TN, int DH, bool EXACT>
__global__ void __launch_bounds__(NT, 1) enc_layer_kernel(const LayerArgs p) {
  constexpr int D = 32 * TN;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x / p.cl, rank = blockIdx.x - b * p.cl, T = p.T;
  const size_t vid = (size_t)b * T * D;
  const float* x = p.x + vid;
  float* qkv = p.scratch + b * scratch_per_video(false, p.parts, T, D);
  float* a = qkv + (size_t)T * 3 * D;
  float* h = p.ff.h == nullptr ? nullptr : p.ff.h + (size_t)b * T * p.ff.n;

  project<TN>(smem, x, T, p.self.wqkv, 3 * D, p.self.bqkv, 3, qkv, 3 * D, rank, p.cl);
  phase_sync(p.cl);
  attend<TN, DH, EXACT>(smem, qkv, 3 * D, qkv + D, qkv + 2 * D, 3 * D, p.sbias, b, T, p.H,
                        p.n / p.H, a, rank, p.cl);
  phase_sync(p.cl);
  tails<TN>(smem, p, a, x, p.self, a + (size_t)T * D, h, p.y + vid, rank);
}

// One decoder layer per cluster of p.cl blocks.  Scratch per video: the
// self q, k, v (T, 3D), the cross k, v of the memory (T, 2D), a (T, D; the
// self, then the cross attention output), x1 (T, D), the cross q (T, D),
// then the FF split's partials.
template <int TN, int DH, bool EXACT>
__global__ void __launch_bounds__(NT, 1) dec_layer_kernel(const LayerArgs p) {
  constexpr int D = 32 * TN;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x / p.cl, rank = blockIdx.x - b * p.cl, T = p.T;
  const size_t vid = (size_t)b * T * D;
  const float* x = p.x + vid;
  float* sqkv = p.scratch + b * scratch_per_video(true, p.parts, T, D);
  float* ckv = sqkv + (size_t)T * 3 * D;
  float* a = ckv + (size_t)T * 2 * D;
  float* x1 = a + (size_t)T * D;
  float* q2 = x1 + (size_t)T * D;

  project<TN>(smem, x, T, p.self.wqkv, 3 * D, p.self.bqkv, 3, sqkv, 3 * D, rank, p.cl);
  project<TN>(smem, p.mem + vid, T, p.cross.wqkv + D, 3 * D, p.cross.bqkv + D, 2, ckv, 2 * D,
              rank, p.cl);
  phase_sync(p.cl);
  attend<TN, DH, EXACT>(smem, sqkv, 3 * D, sqkv + D, sqkv + 2 * D, 3 * D, p.sbias, b, T,
                        p.H, p.n / p.H, a, rank, p.cl);
  phase_sync(p.cl);
  dec_self_tail<TN>(smem, a, x, p.self, p.cross, p.g1, p.be1, p.n, x1, q2, T, rank, p.cl);
  phase_sync(p.cl);  // q2 and x1 are complete, a is read
  attend<TN, DH, EXACT>(smem, q2, D, ckv, ckv + D, 2 * D, p.cbias, b, T, p.H, p.n / p.H, a,
                        rank, p.cl);
  phase_sync(p.cl);
  tails<TN>(smem, p, a, x1, p.cross, q2 + (size_t)T * D, nullptr, p.y + vid, rank);
}

template <int TN, int DH, bool EXACT>
int launch(const LayerArgs& p, int B, bool decoder, cudaStream_t st) {
  constexpr int smem = Geo<TN>::SMEM;
  static bool ready_enc = false, ready_dec = false;
  auto kernel = decoder ? dec_layer_kernel<TN, DH, EXACT> : enc_layer_kernel<TN, DH, EXACT>;
  cudaError_t e = allow_smem(kernel, smem, decoder ? ready_dec : ready_enc);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.cl);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = p.cl;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The FF split is valid: one part without a float FF tail; else at most
// one part per FF chunk and every part of every row tile a block of the
// cluster.
bool parts_ok(const LayerArgs& p, int D) {
  if (p.parts == 1) return true;
  const int tiles = (p.T + row_tile(D) - 1) / row_tile(D);
  return p.parts > 1 && p.ff.w1 != nullptr && p.ff.q.w1q == nullptr &&
         p.parts <= (p.ff.n + D - 1) / D && p.parts * tiles <= p.cl;
}

int dispatch(const LayerArgs& p, int B, int D, bool decoder, cudaStream_t st) {
  if (p.H <= 0 || p.n > D || p.n % p.H || p.ff.n % 4 || p.cl < 1 || p.cl > 8 ||
      !parts_ok(p, D))
    return (int)cudaErrorInvalidValue;
  return by_width(D, [&](auto tn) {
    return by_head<32 * decltype(tn)::value>(p.n / p.H, [&](auto hb) {
      using HB = decltype(hb);
      return launch<decltype(tn)::value, HB::DH, HB::EXACT>(p, B, decoder, st);
    });
  });
}

Bias bias_of(const void* mask, const void* valid, int repeat_inc, int add_keypad) {
  return Bias{(const float*)mask, (const float*)valid, repeat_inc, add_keypad};
}

// The encoder layer's arguments but its FF tail.
LayerArgs encoder_args(const void* x, int T, int n, int H, int cl, int parts,
                       const void* wqkv, const void* bqkv, const void* wo, const void* bo,
                       const void* mask, const void* valid, int repeat_inc, int add_keypad,
                       void* y, void* scratch) {
  auto f = [](const void* v) { return (const float*)v; };
  LayerArgs p{};
  p.x = f(x);
  p.y = (float*)y;
  p.scratch = (float*)scratch;
  p.T = T;
  p.H = H;
  p.n = n;
  p.cl = cl;
  p.parts = parts;
  p.self = Attn{f(wqkv), f(bqkv), f(wo), f(bo)};
  p.sbias = bias_of(mask, valid, repeat_inc, add_keypad);
  return p;
}

}  // namespace

// x (B, T, D) -> y (B, T, D): one encoder layer, a cluster of cl (1 to 8)
// blocks per video, the FF chunks of each row tile (row_tile(D) rows)
// split over parts of them (1: none; else at most one part per D-wide
// chunk, and parts times the row tiles at most cl).  Weights in the Flax
// layout: wqkv (D, 3D), wo (D, D), w1 (D, FF), w2 (FF, D); g1/be1 LN1,
// g2/be2 LN2.  mask, valid (B, T) may be null (no mask term / every key
// valid).  scratch holds B scratch_per_video(false, parts, T, D) floats
// (4 T D a video, and parts T D more with the split), zero in its
// attention-output columns H * (n / H) and up when n < D.  D is
// 128, 256, 384 or 512; n <= D the model's true width (the operands
// zero-padded from n to D; see common.cuh), n / H a multiple of 4 up to
// 512; FF a multiple of 4.
extern "C" int kit_enc_layer(const void* x, int B, int T, int D, int n, int H, int FF, int cl,
                             int parts, const void* wqkv, const void* bqkv, const void* wo,
                             const void* bo,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             const void* g1, const void* be1, const void* g2, const void* be2,
                             const void* mask, const void* valid, int repeat_inc,
                             int add_keypad, void* y, void* scratch, void* stream) {
  auto f = [](const void* v) { return (const float*)v; };
  LayerArgs p = encoder_args(x, T, n, H, cl, parts, wqkv, bqkv, wo, bo, mask, valid,
                             repeat_inc, add_keypad, y, scratch);
  p.ff = FeedFwd{f(w1), f(b1), f(w2), f(b2), f(g1), f(be1), f(g2), f(be2), FF, FFInt8{},
                 nullptr};
  return dispatch(p, B, D, false, (cudaStream_t)stream);
}

// kit_enc_layer with its FF tail int8: w1q (FF, D) and w2q (D, FF) int8 in
// torch's Linear layout with per-row scales w1s (FF) and w2s (D); h holds
// B T FF floats of scratch.  parts must be 1: the int8 tail takes a whole
// row tile.
extern "C" int kit_enc_layer_int8(const void* x, int B, int T, int D, int n, int H, int FF,
                                  int cl, int parts, const void* wqkv, const void* bqkv,
                                  const void* wo, const void* bo, const void* w1q,
                                  const void* w1s,
                                  const void* b1, const void* w2q, const void* w2s,
                                  const void* b2, const void* g1, const void* be1,
                                  const void* g2, const void* be2, const void* mask,
                                  const void* valid, int repeat_inc, int add_keypad, void* y,
                                  void* scratch, void* h, void* stream) {
  auto f = [](const void* v) { return (const float*)v; };
  LayerArgs p = encoder_args(x, T, n, H, cl, parts, wqkv, bqkv, wo, bo, mask, valid,
                             repeat_inc, add_keypad, y, scratch);
  p.ff = FeedFwd{nullptr, f(b1), nullptr, f(b2), f(g1), f(be1), f(g2), f(be2), FF,
                 FFInt8{(const int8_t*)w1q, f(w1s), f(b1), (const int8_t*)w2q, f(w2s), f(b2), FF},
                 (float*)h};
  return dispatch(p, B, D, false, (cudaStream_t)stream);
}

// x, mem (B, T, D) -> y (B, T, D): one decoder layer, cl blocks per video
// and its FF chunks over parts of them, as kit_enc_layer's (parts 1
// without the FF tail).
// s* the self-attention weights, c* the cross-attention ones (layouts as
// above), g1/be1 LN1.  w1 null means no FF tail (y = x1 + CA(x1, mem)); else w1,
// b1, w2, b2 with g2/be2 LN2 and g3/be3 LN3.  smask/svalid and
// cmask/cvalid (B, T) build the self and cross bias and may be null.
// scratch holds B scratch_per_video(true, parts, T, D) floats (8 T D a
// video, and parts T D more with the split), zero in its attention-output
// columns as kit_enc_layer's.  D, n and H as kit_enc_layer takes them.
extern "C" int kit_dec_layer(const void* x, const void* mem, int B, int T, int D, int n, int H,
                             int FF, int cl, int parts, const void* swqkv,
                             const void* sbqkv, const void* swo, const void* sbo,
                             const void* cwqkv, const void* cbqkv,
                             const void* cwo, const void* cbo, const void* g1, const void* be1,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             const void* g2, const void* be2, const void* g3, const void* be3,
                             const void* smask, const void* svalid, int srepeat_inc,
                             int sadd_keypad, const void* cmask, const void* cvalid,
                             int crepeat_inc, int cadd_keypad, void* y, void* scratch,
                             void* stream) {
  auto f = [](const void* v) { return (const float*)v; };
  LayerArgs p{};
  p.x = f(x);
  p.mem = f(mem);
  p.y = (float*)y;
  p.scratch = (float*)scratch;
  p.T = T;
  p.H = H;
  p.n = n;
  p.cl = cl;
  p.parts = parts;
  p.self = Attn{f(swqkv), f(sbqkv), f(swo), f(sbo)};
  p.cross = Attn{f(cwqkv), f(cbqkv), f(cwo), f(cbo)};
  p.g1 = f(g1);
  p.be1 = f(be1);
  p.sbias = bias_of(smask, svalid, srepeat_inc, sadd_keypad);
  p.cbias = bias_of(cmask, cvalid, crepeat_inc, cadd_keypad);
  p.ff = FeedFwd{f(w1), f(b1), f(w2), f(b2), f(g2), f(be2), f(g3), f(be3),
                 w1 == nullptr ? 0 : FF};
  return dispatch(p, B, D, true, (cudaStream_t)stream);
}
