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
// at B = 256), the decoder layer 2 D (8 D + 2 FF) + 8 H T dh (3.4 MFLOP per
// token), against 2-3 KB per token in and out and 4-6 MB of weights that
// stay in the 50 MB L2.
//
// Design.  Nothing of a whole layer fits one SM: at T = 128 a video's q, k
// and v are 384 KB, its FF hidden 1 MB.  Here a thread-block cluster of
// cl blocks of 256 threads owns one video and walks the layer's phases in
// order, each phase's work split over the cluster's blocks, with a
// cluster barrier between phases; what must outlive a phase goes to
// per-video scratch in device memory (the wrapper allocates it) and is
// read back through L2 (ld.global.cg), so no intermediate returns to
// PyTorch between the sublayers:
//   1. projections, one (32-row tile, D-wide column part) product per step
//      of a block, by the FFMA block product of common.cuh: q, k, v (and,
//      in the decoder, the cross-attention k, v of the memory); written to
//      scratch;
//   2. attention: each thread takes one (head, query) of the video at a
//      time (the block's share of the H T of them, in rounds of 256); keys
//      and values of the block's heads stream through shared memory 32
//      keys at a time, the online softmax of attention.cuh folds them;
//      writes a (T, D) to scratch;
//   3. per 32-row tile: the out-projection and residual, LN1, then the FF
//      tail exactly as ffn.cu runs it (x1 in shared memory, the FF axis in
//      D-wide chunks with the GELU chunk on chip, LN2 in registers); the
//      decoder instead writes x1 and the cross-attention q, runs phase 2
//      again on them, then the cross out-projection, residual and its FF
//      tail.
// The wrapper sizes the cluster to about one block per SM over the batch
// (1 to 8 blocks; 90 KB of shared memory each at D = 256, two fit an SM):
// a batch of 256 videos takes clusters of 1, a single video one of 8, so
// one request is spread over 8 SMs instead of waiting on one.  The blocks
// of a cluster share no shared memory here (distributed shared memory
// would keep the hand-offs off L2 and is later work).
// Not copied from the TPU kernel: the bf16x3 stacked weights, the bb row
// batching and the VMEM budgets (T is free here).
#include <cooperative_groups.h>

#include "attention.cuh"
#include "common.cuh"
#include "int8.cuh"

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
  float* scratch;    // per video: 4 T D floats (encoder), 8 T D (decoder)
  int T, H;
  int n;             // the model's true width (see common.cuh); n / H the head width
  int cl;            // blocks per video: the cluster size
  Attn self, cross;
  const float *g1, *be1;  // the decoder's LN1
  Bias sbias, cbias;
  FeedFwd ff;             // ff.w1 null: the decoder without its FF tail
};

// stage_rows for a source this block wrote earlier in the launch: loads
// through L2 (ld.global.cg), never a stale read-only-cache line.
__device__ __forceinline__ void stage_cg(float* AT, const float* src, int row0, int M, int K) {
  for (int idx = threadIdx.x; idx < BM * K; idx += NT) {
    int r = idx / K, c = idx - r * K;
    int row = row0 + r;
    AT[c * LDT + r] = row < M ? __ldcg(src + (size_t)row * K + c) : 0.f;
  }
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

template <int TN>
__device__ __forceinline__ void zero(float (&v)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) v[i][j] = 0.f;
}

// dst[:, p D .. (p + 1) D) = src W[:, p D ..] + bias[p D ..] for p < parts,
// over the video's T rows of width D (row strides D and ldd): this block's
// share, a contiguous run of the (row tile, part) products.
template <int TN>
__device__ void project(float* Xs, float* Ws, const float* src, int T, const float* W, int ldw,
                        const float* bias, int parts, float* dst, int ldd, int rank, int cl) {
  constexpr int D = 32 * TN;
  const int total = (T + BM - 1) / BM * parts, per = (total + cl - 1) / cl;
  const int end = min(total, (rank + 1) * per);
  int staged = -1;
  for (int k = rank * per; k < end; ++k) {
    const int tile = k / parts, p = k - tile * parts, row0 = tile * BM;
    if (tile != staged) {
      __syncthreads();  // Xs is free
      stage_cg(Xs, src, row0, T, D);
      __syncthreads();
      staged = tile;
    }
    float acc[TM][TN];
    zero<TN>(acc);
    mma_rows<TN>(acc, Xs, D, W + p * D, ldw, D, Ws);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += __ldg(bias + p * D + col_of(j));
    store_rows<TN>(dst + p * D, ldd, D, row0, T, acc);
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

// r = res + (a Wo + bo) for rows [row0, row0 + BM) of the video; a and res
// (T, D) were written earlier in the launch or are inputs.  The caller has
// made Xs free.  Ends with a barrier (mma_rows').
template <int TN>
__device__ __forceinline__ void out_proj(float (&r)[TM][TN], float* Xs, float* Ws,
                                         const float* a, const float* res, int row0, int T,
                                         const float* wo, const float* bo) {
  constexpr int D = 32 * TN;
  stage_cg(Xs, a, row0, T, D);
  __syncthreads();
  zero<TN>(r);
  mma_rows<TN>(r, Xs, D, wo, D, D, Ws);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + row_of(i);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col_of(j);
      const float xr = row < T ? __ldcg(res + (size_t)row * D + c) : 0.f;
      r[i][j] = xr + (r[i][j] + __ldg(bo + c));
    }
  }
}

// v = LN_out(v + gelu(v W1 + b1) W2 + b2) for the tile whose rows v holds
// (already LN_in-normalized), as ffn.cu's kernel: v through Xs, the FF axis
// in D-wide chunks, each chunk's GELU output in Hs.  Xs and Hs must be free.
// n: the true width LN_out takes its statistics over.
template <int TN>
__device__ void ff_tile(float (&v)[TM][TN], float* Xs, float* Hs, float* Ws, FeedFwd ff, int n) {
  constexpr int D = 32 * TN;
  put_rows<TN>(Xs, v);
  __syncthreads();
  float z[TM][TN];
  zero<TN>(z);
  for (int f0 = 0; f0 < ff.n; f0 += D) {
    const int fc = min(D, ff.n - f0);
    zero<TN>(v);
    mma_rows<TN>(v, Xs, D, ff.w1 + f0, ff.n, fc, Ws);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = col_of(j);
        v[i][j] = c < fc ? gelu(v[i][j] + __ldg(ff.b1 + f0 + c)) : 0.f;
      }
    put_rows<TN>(Hs, v);
    __syncthreads();
    mma_rows<TN>(z, Hs, fc, ff.w2 + (size_t)f0 * D, D, D, Ws);
  }
  get_rows<TN>(v, Xs);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) v[i][j] = v[i][j] + (z[i][j] + __ldg(ff.b2 + col_of(j)));
  layer_norm<TN>(v, ff.g_out, ff.be_out, n);
}

// The FF tail of one tile (v = LN_in(r) on entry): the float32 one, or the
// int8 one when ff.q.w1q is set; rows [row0, row0 + BM) of video b.
template <int TN>
__device__ __forceinline__ void ff_tail(float (&v)[TM][TN], float* Xs, float* Hs, float* Ws,
                                        const FeedFwd& ff, int n, int b, int T, int row0) {
  if (ff.q.w1q != nullptr) {
    put_rows<TN>(Xs, v);
    ff_int8_rows<TN>(Xs, Hs, ff.q, ff.h + ((size_t)b * T + row0) * ff.q.n, ff.q.n,
                     min(BM, T - row0));
    get_rows<TN>(v, Xs);
    layer_norm<TN>(v, ff.g_out, ff.be_out, n);
  } else {
    ff_tile<TN>(v, Xs, Hs, Ws, ff, n);
  }
}

// One encoder layer per cluster of p.cl blocks (one cluster per video).
// Scratch per video: qkv (T, 3D), then a (T, D).
template <int TN, int DH, bool EXACT>
__global__ void __launch_bounds__(NT, 2) enc_layer_kernel(const LayerArgs p) {
  constexpr int D = 32 * TN;
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;                // D x LDT
  float* Hs = smem + D * LDT;      // D x LDT
  float* Ws = smem + 2 * D * LDT;  // BK x D
  const int b = blockIdx.x / p.cl, rank = blockIdx.x - b * p.cl, T = p.T;
  const size_t vid = (size_t)b * T * D;
  const float* x = p.x + vid;
  float* qkv = p.scratch + 4 * vid;
  float* a = qkv + (size_t)T * 3 * D;

  project<TN>(Xs, Ws, x, T, p.self.wqkv, 3 * D, p.self.bqkv, 3, qkv, 3 * D, rank, p.cl);
  phase_sync(p.cl);
  attend<TN, DH, EXACT>(smem, qkv, 3 * D, qkv + D, qkv + 2 * D, 3 * D, p.sbias, b, T, p.H,
                        p.n / p.H, a, rank, p.cl);
  phase_sync(p.cl);
  for (int row0 = rank * BM; row0 < T; row0 += p.cl * BM) {
    __syncthreads();  // Xs and Hs are free
    float v[TM][TN];
    out_proj<TN>(v, Xs, Ws, a, x, row0, T, p.self.wo, p.self.bo);
    layer_norm<TN>(v, p.ff.g_in, p.ff.be_in, p.n);          // LN1
    ff_tail<TN>(v, Xs, Hs, Ws, p.ff, p.n, b, T, row0);      // LN2(x1 + FF(x1))
    store_rows<TN>(p.y + vid, D, D, row0, T, v);
  }
}

// One decoder layer per cluster of p.cl blocks.  Scratch per video: the
// self q, k, v (T, 3D), the cross k, v of the memory (T, 2D), a (T, D; the
// self, then the cross attention output), x1 (T, D) and the cross q
// (T, D).
template <int TN, int DH, bool EXACT>
__global__ void __launch_bounds__(NT, 2) dec_layer_kernel(const LayerArgs p) {
  constexpr int D = 32 * TN;
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;                // D x LDT
  float* Hs = smem + D * LDT;      // D x LDT
  float* Ws = smem + 2 * D * LDT;  // BK x D
  const int b = blockIdx.x / p.cl, rank = blockIdx.x - b * p.cl, T = p.T;
  const size_t vid = (size_t)b * T * D;
  const float* x = p.x + vid;
  float* sqkv = p.scratch + 8 * vid;
  float* ckv = sqkv + (size_t)T * 3 * D;
  float* a = ckv + (size_t)T * 2 * D;
  float* x1 = a + (size_t)T * D;
  float* q2 = x1 + (size_t)T * D;

  project<TN>(Xs, Ws, x, T, p.self.wqkv, 3 * D, p.self.bqkv, 3, sqkv, 3 * D, rank, p.cl);
  project<TN>(Xs, Ws, p.mem + vid, T, p.cross.wqkv + D, 3 * D, p.cross.bqkv + D, 2, ckv, 2 * D,
              rank, p.cl);
  phase_sync(p.cl);
  attend<TN, DH, EXACT>(smem, sqkv, 3 * D, sqkv + D, sqkv + 2 * D, 3 * D, p.sbias, b, T,
                        p.H, p.n / p.H, a, rank, p.cl);
  phase_sync(p.cl);
  for (int row0 = rank * BM; row0 < T; row0 += p.cl * BM) {
    __syncthreads();
    float v[TM][TN];
    out_proj<TN>(v, Xs, Ws, a, x, row0, T, p.self.wo, p.self.bo);
    layer_norm<TN>(v, p.g1, p.be1, p.n);  // x1 = LN1(x + SA(x))
    store_rows<TN>(x1, D, D, row0, T, v);
    put_rows<TN>(Xs, v);
    __syncthreads();
    zero<TN>(v);
    mma_rows<TN>(v, Xs, D, p.cross.wqkv, 3 * D, D, Ws);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) v[i][j] += __ldg(p.cross.bqkv + col_of(j));
    store_rows<TN>(q2, D, D, row0, T, v);
  }
  phase_sync(p.cl);  // q2 and x1 are complete, a is read
  attend<TN, DH, EXACT>(smem, q2, D, ckv, ckv + D, 2 * D, p.cbias, b, T, p.H, p.n / p.H, a,
                        rank, p.cl);
  phase_sync(p.cl);
  for (int row0 = rank * BM; row0 < T; row0 += p.cl * BM) {
    __syncthreads();
    float v[TM][TN];
    out_proj<TN>(v, Xs, Ws, a, x1, row0, T, p.cross.wo, p.cross.bo);  // r = x1 + CA
    if (p.ff.w1 != nullptr) {
      layer_norm<TN>(v, p.ff.g_in, p.ff.be_in, p.n);  // x2 = LN2(r)
      ff_tile<TN>(v, Xs, Hs, Ws, p.ff, p.n);          // LN3(x2 + FF(x2))
    }
    store_rows<TN>(p.y + vid, D, D, row0, T, v);
  }
}

template <int TN, int DH, bool EXACT>
int launch(const LayerArgs& p, int B, bool decoder, cudaStream_t st) {
  constexpr int D = 32 * TN;
  constexpr int rows = 2 * D * LDT + BK * D, keys = 2 * KT * D + 2 * KT;
  constexpr int smem = (rows > keys ? rows : keys) * (int)sizeof(float);
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

int dispatch(const LayerArgs& p, int B, int D, bool decoder, cudaStream_t st) {
  if (p.H <= 0 || p.n > D || p.n % p.H || p.ff.n % 4 || p.cl < 1 || p.cl > 8)
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
LayerArgs encoder_args(const void* x, int T, int n, int H, int cl, const void* wqkv,
                       const void* bqkv, const void* wo, const void* bo, const void* mask,
                       const void* valid, int repeat_inc, int add_keypad, void* y,
                       void* scratch) {
  auto f = [](const void* v) { return (const float*)v; };
  LayerArgs p{};
  p.x = f(x);
  p.y = (float*)y;
  p.scratch = (float*)scratch;
  p.T = T;
  p.H = H;
  p.n = n;
  p.cl = cl;
  p.self = Attn{f(wqkv), f(bqkv), f(wo), f(bo)};
  p.sbias = bias_of(mask, valid, repeat_inc, add_keypad);
  return p;
}

}  // namespace

// x (B, T, D) -> y (B, T, D): one encoder layer, a cluster of cl (1 to 8)
// blocks per video.  Weights in the Flax layout: wqkv (D, 3D), wo (D, D),
// w1 (D, FF), w2 (FF, D); g1/be1 LN1, g2/be2 LN2.  mask, valid (B, T) may
// be null (no mask term / every key valid).  scratch holds 4 B T D floats,
// zero in its attention-output columns H * (n / H) and up when n < D.  D is
// 128, 256, 384 or 512; n <= D the model's true width (the operands
// zero-padded from n to D; see common.cuh), n / H a multiple of 4 up to
// 512; FF a multiple of 4.
extern "C" int kit_enc_layer(const void* x, int B, int T, int D, int n, int H, int FF, int cl,
                             const void* wqkv, const void* bqkv, const void* wo, const void* bo,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             const void* g1, const void* be1, const void* g2, const void* be2,
                             const void* mask, const void* valid, int repeat_inc,
                             int add_keypad, void* y, void* scratch, void* stream) {
  auto f = [](const void* v) { return (const float*)v; };
  LayerArgs p = encoder_args(x, T, n, H, cl, wqkv, bqkv, wo, bo, mask, valid, repeat_inc,
                             add_keypad, y, scratch);
  p.ff = FeedFwd{f(w1), f(b1), f(w2), f(b2), f(g1), f(be1), f(g2), f(be2), FF, FFInt8{},
                 nullptr};
  return dispatch(p, B, D, false, (cudaStream_t)stream);
}

// kit_enc_layer with its FF tail int8: w1q (FF, D) and w2q (D, FF) int8 in
// torch's Linear layout with per-row scales w1s (FF) and w2s (D); h holds
// B T FF floats of scratch.
extern "C" int kit_enc_layer_int8(const void* x, int B, int T, int D, int n, int H, int FF,
                                  int cl, const void* wqkv, const void* bqkv, const void* wo,
                                  const void* bo, const void* w1q, const void* w1s,
                                  const void* b1, const void* w2q, const void* w2s,
                                  const void* b2, const void* g1, const void* be1,
                                  const void* g2, const void* be2, const void* mask,
                                  const void* valid, int repeat_inc, int add_keypad, void* y,
                                  void* scratch, void* h, void* stream) {
  auto f = [](const void* v) { return (const float*)v; };
  LayerArgs p = encoder_args(x, T, n, H, cl, wqkv, bqkv, wo, bo, mask, valid, repeat_inc,
                             add_keypad, y, scratch);
  p.ff = FeedFwd{nullptr, f(b1), nullptr, f(b2), f(g1), f(be1), f(g2), f(be2), FF,
                 FFInt8{(const int8_t*)w1q, f(w1s), f(b1), (const int8_t*)w2q, f(w2s), f(b2), FF},
                 (float*)h};
  return dispatch(p, B, D, false, (cudaStream_t)stream);
}

// x, mem (B, T, D) -> y (B, T, D): one decoder layer, cl blocks per video.
// s* the self-attention weights, c* the cross-attention ones (layouts as
// above), g1/be1 LN1.  w1 null means no FF tail (y = x1 + CA(x1, mem)); else w1,
// b1, w2, b2 with g2/be2 LN2 and g3/be3 LN3.  smask/svalid and
// cmask/cvalid (B, T) build the self and cross bias and may be null.
// scratch holds 8 B T D floats, zero in its attention-output columns as
// kit_enc_layer's.  D, n and H as kit_enc_layer takes them.
extern "C" int kit_dec_layer(const void* x, const void* mem, int B, int T, int D, int n, int H,
                             int FF, int cl, const void* swqkv, const void* sbqkv, const void* swo,
                             const void* sbo, const void* cwqkv, const void* cbqkv,
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
