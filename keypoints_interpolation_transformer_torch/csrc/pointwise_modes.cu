// The pre-stream chain with its embedding (kit_pre_embed_tc) and the post
// head (kit_post_head_tc) of the KeypointCompleter in the precision modes
// "high" (bf16x3) and "default" (one bf16 pass).
//
// Replaces keypoints_interpolation_transformer_tpu/ops/pallas/pointwise.py
// under those modes: _pre_embed_kernel (pre_stream_embed_high, _default)
// and _post_kernel (post_head_high, _default), as _pre_embed_pallas and
// _post_pallas call them.  The contract, the TPU kernels' mode arithmetic
// (_prep, _proj, _prep_weights: every product x_hi W_hi + x_hi W_lo + x_lo
// W_hi at "high" or x_hi W_hi at "default", hi = bf16(x), lo = bf16(x -
// hi) nearest even, its float32 sum then + bias; each activation split
// again before the product that reads it):
//   pre   e = x Wemb + bemb (x's F = 108 features zero-padded);
//         n = token_norm(e) [doubled for the Cycle residual] + (pe +
//         learned);  g = (n W1 + b1) * sigmoid(n W2 + b2);  s = g W3 + b3;
//         e is also an output (the post head's residual);
//   post  g from decoded as above;  z = token_norm((g W3 + b3) + f);
//         z = z * sigmoid(z);  out = z Wh + bh.
// token_norm, sigmoid, biases and the positional sum stay float32.
//
// What bounds it on an H100: the bf16 tensor cores at "high" (2 (F D + 3
// D^2) FLOP a token, three passes: 14.7 GFLOP x 3 a stream at B = 256, T =
// 128, D = 256, about 45 us at 989 TFLOP/s) and the bytes at "default" (x
// in, s and e out).  What holds the one-launch form below its bound on an
// H100 (layer_probe.py chainphases): the consumers' scalar phases (the
// norms, the gate's sigmoids, the loads and stores of device memory) run
// between the tensor-core phases, not beside them.
//
// Design at D <= 256 (chain_tc_kernel): ONE launch a chain, on the
// structure of ffn_tc.cuh's ffn_tc_kernel: a block owns 128 token rows (64
// a consumer warpgroup) for the whole chain; a producer warpgroup streams
// every weight tile of the chain, in the order the consumers read them,
// through a TMA ring of 128-row x 64-deep tiles (both planes a stage at
// "high"), each weight as K-major planes (the transposes, made once per
// weight version by the wrapper, chain_planes: [W1 | W2]^T with its rows
// interleaved per 64 output columns, W3^T, Wemb^T (D, FP) or Wh^T (FP, D),
// FP = F rounded up to 16; TMA zero-fills past FP).  Nothing but x (or the
// decoded rows and f) comes in and s, e (or out) go out:
//   * pre: a thread loads its m64k16 fragments of x straight from device
//     memory (float pairs of rows r and r + 8), splits them in registers and
//     feeds them to wgmma as a register A (as mode_linear_kernel splits x);
//     e = x Wemb in two m64n128 sums at D = 256, each 64-deep block of F
//     its own chain of sums (the first parked in shared memory), + bemb, e
//     written where asked; token_norm over each row in the accumulators'
//     own layout (a row's D values lie in the four lanes of a quad) in
//     common.cuh's row_norm order: e and n in the five-launch form's
//     float32 order (at "default" n is rounded to one bf16, and an n that
//     another float32 order puts across a rounding midpoint moves a row of
//     s by one bf16 step of n times its weights: 2.2e-3 of s's largest
//     value on a standing draw); + pe[row % T] (doubled first with
//     the Cycle residual), and n's planes written K-major in the 128-byte
//     swizzle into shared memory;
//   * post: the decoded rows split into the same planes by whole warps;
//   * the SwiGLU body, for each 64-column chunk c of D: [x1 | x2] = n [W1 |
//     W2] over the chunk's 128 interleaved columns (wgmma m64n128, both
//     operands in shared memory), + b12, g = x1 * sigmoid(x2) in float32 in
//     the accumulators (a thread holds x1 and x2 of the same columns), g
//     split into the register-A fragments of the next product, and s += g
//     W3[64 c .. 64 c + 63, :], one 16-deep step at a time: a step's
//     products run on the tensor cores while the next step is gated (the
//     gate's float32 sigmoids are a consumer's largest scalar work); drained
//     before the next chunk's gate rewrites the fragments, which keeps a
//     consumer within its 232 registers (s's 64 x D sums, the chunk's 64 x
//     128 and the fragments);
//   * s's sums start at b3 (b3 + f in the post head: only the float32 order
//     of the sum differs); pre ends with s written out; post takes
//     token_norm and swish in the accumulators, writes z's planes where the
//     decoded rows' were and runs the head product from them (its N = FP <=
//     128 columns in one m64n128 sum; z as register-A fragments beside
//     those sums spilled), + bh, F columns written.  Both take F <= 128
//     (the frames' 108: the embedding's two 64-deep sums, the head's one
//     m64n128 sum).
// At D = 384 and 512 the SwiGLU sums would not fit a consumer's registers
// with 64 rows a group; there, and for F > 128 at any width, each chain
// stays the short sequence of launches of pointwise_modes' first form
// (the wrapper picks the form by passing scratch or not, see the C
// entries): the products on tc_gemm.cuh's
// tc_gemm_kernel with the same K-major planes (TB 0), whose epilogues add
// the bias (EPI_BIAS), the bias and the residual f (EPI_RES), or gate the
// interleaved [W1 | W2] pair and split it (EPI_GLU); the row steps
// (token_norm over a D-wide row, the positional sum, swish) one warp a row,
// writing the planes the next product reads: pre: split x, embed, norm,
// W12 + gate, W3 (5 launches); post: split decoded, W12 + gate, W3 + f, norm
// + swish, head (5), the intermediates in scratch the wrapper allocates.
// Not copied from the TPU kernel: the stacked [hi | hi | lo] contraction
// (the same three terms; only the float32 sum order differs), its padding
// of F to 128 lanes (to 112 here, the TMA row rule), the bb row batching.
#include "attn_modes.cuh"
#include "common.cuh"
#include "grad.cuh"
#include "mma_bf16.cuh"
#include "tc_gemm.cuh"

using namespace kit;

// (Kernels in namespace kit: see attention_modes.cu.)
namespace kit {

// ---- the one-launch chains (D <= 256) ------------------------------------------

// F's padding: the planes' rows 16-byte aligned for TMA, the product's K a
// multiple of 16.
__host__ __device__ constexpr int pad_f(int F) { return (F + 15) / 16 * 16; }

// The one-launch chains' geometry at D = 32 TN <= 256 in the mode's
// PASSES: the activation's planes (128 rows x D, K-major, swizzled), then
// a ring of STAGES stages, each one 128-row x 64-deep weight tile a plane.
template <int TN, int PASSES>
struct ChainTc {
  static constexpr int D = 32 * TN;
  static constexpr int ROWS = 128;                // 64 a consumer group
  static constexpr int NH = D / 128;              // 128-column halves of a D-wide sum
  static constexpr int KB = D / 64;               // 64-deep blocks of D; gate chunks
  static constexpr int PLANES = PASSES == 3 ? 2 : 1;
  static constexpr int AP = ROWS * D * 2;         // bytes of one plane of the activation
  // before the ring: the activation's planes, where the pre chain first
  // parks e's first 64-deep chain of sums (ROWS x D floats, more than one
  // plane at "default")
  static constexpr int AREA = cmax(AP * PLANES, ROWS * D * 4);
  static constexpr int STAGE = TC_TILE * PLANES;
  static constexpr int STAGES = cmin(MAX_STAGES, (TC_SMEM - AREA) / STAGE);
  static constexpr int SMEM = AREA + STAGES * STAGE + 1024;
  static_assert(D == 128 || D == 256, "one launch a chain up to D = 256");
  static_assert(STAGES >= 3, "a ring of at least three stages");
};

// The chain's weight planes as TMA reads them (128-row x 64 boxes, K-major):
// [W1 | W2]^T (2D, D) interleaved, W3^T (D, D), and Wemb^T (D, FP) or Wh^T
// (FP, D); [1] the lo planes (zero maps at "default").
struct ChainMaps {
  CUtensorMap w12[2], w3[2], wx[2];
};

struct ChainArgs {
  const float* x;   // pre: the frames (M, F); post: the decoded rows (M, D)
  const float* f;   // post: the filled embedding (M, D)
  int M, T, F, pe_residual;
  const float *bx;  // pre: bemb (D); post: bh (F)
  const float *pe;  // pre: (T, D), row m reads pe[m % T]
  const float *b12, *b3;  // [b1 | b2] (2D) as it is; b3 (D)
  float* out;       // pre: s (M, D); post: (M, F)
  float* emb;       // pre: e (M, D), or null
};

// sigmoid(x) = 1 / (1 + exp(-x)) in float32: expf, then the reciprocal by
// the hardware's approximation and one Newton step (within an ulp of the
// IEEE quotient; 0 where exp overflows).  The IEEE division's branch to its
// slow path kept the compiler from overlapping one element's latency with
// the next one's, so the gate and the swish ran a sigmoid at a time.
__device__ __forceinline__ float sigmoid_nr(float x) {
  const float y = 1.f + expf(-x);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  r = fmaf(fmaf(-y, r, 1.f), r, r);
  return y == __int_as_float(0x7f800000) ? 0.f : r;
}

__device__ __forceinline__ void prefetch_l1(const float* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// The sums of common.cuh's row_norm over the thread's row r (v as
// quad_token_norm takes it): row_norm's lane l holds columns 4 l .. 4 l + 3
// (and + 128 at D = 256) of a row and sums them in that order (add(a, x)
// each), then the lanes' sums go through a tree (lane bits 4, 3, 2, 1, 0).
// Here lane l's columns lie in two threads of the quad (8 jj + 2 t + q: l
// = 2 jj + t / 2, the first two in t = 2 (l & 1), the next two in t + 1),
// so the partial sums move between them by shuffles, and the tree runs
// over jj's bits 3 .. 0 in a thread, then over t's bit 1: the same float32
// operations in the same order as the five-launch form's norm.
template <int NH, typename Add>
__device__ __forceinline__ float row_norm_sum(const float (&v)[NH][64], int r, Add add) {
  const bool odd = threadIdx.x & 1;
  float a[16];
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) a[jj] = 0.f;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // the even thread's two, then the odd one's
      if (h > 0 || half > 0)
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) a[jj] = __shfl_xor_sync(0xffffffffu, a[jj], 1);
      if (odd == (half == 1))
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          a[jj] = add(a[jj], v[h][4 * jj + 2 * r]);
          a[jj] = add(a[jj], v[h][4 * jj + 2 * r + 1]);
        }
    }
  }
  // the odd threads hold the lane sums: the tree, lane bit 4 (jj bit 3) first
#pragma unroll
  for (int w = 8; w >= 1; w /= 2)
#pragma unroll
    for (int jj = 0; jj < w; ++jj) a[jj] = a[jj] + a[jj + w];
  float tot = a[0] + __shfl_xor_sync(0xffffffffu, a[0], 2);
  const float other = __shfl_xor_sync(0xffffffffu, tot, 1);
  return odd ? tot : other;
}

// token_norm over the two rows of a quad's accumulators (see the note at
// the top): v[h][4 jj + 2 r + q] is row r (of the thread's two) of column
// 128 h + 8 jj + 2 t + q; statistics over all D columns.  ROW_ORDER (the
// pre chain's n): in row_norm's float32 order (row_norm_sum), since at
// "default" n is rounded to one bf16 and an n that another order puts
// across a rounding midpoint moves a whole row of the SwiGLU's products;
// else (the post head's z) each thread's part summed in order, then the
// quad's.
template <int NH, bool ROW_ORDER>
__device__ __forceinline__ void quad_token_norm(float (&v)[NH][64]) {
  const float inv_n = 1.f / (128 * NH);
  auto sum = [&](int r, auto add) {
    if constexpr (ROW_ORDER) {
      return row_norm_sum(v, r, add);
    } else {
      float a = 0.f;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
#pragma unroll
          for (int q = 0; q < 2; ++q) a = add(a, v[h][4 * jj + 2 * r + q]);
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      return a + __shfl_xor_sync(0xffffffffu, a, 2);
    }
  };
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mean = sum(r, [](float s, float x) { return s + x; }) * inv_n;
    const float ss = sum(r, [mean](float s, float x) {
      const float d = x - mean;
      return s + d * d;
    });
    const float inv = rsqrtf(ss * inv_n + LN_EPS);
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float& x = v[h][4 * jj + 2 * r + q];
          x = (x - mean) * inv;
        }
  }
}

// One chain (POST false: pre, true: post) for row tile blockIdx.x.
template <int TN, int PASSES, bool POST>
__global__ void __launch_bounds__(WG_THREADS, 1)
    chain_tc_kernel(const __grid_constant__ ChainMaps mp, const ChainArgs p) {
  using G = ChainTc<TN, PASSES>;
  constexpr int D = G::D, ROWS = G::ROWS, NH = G::NH, KB = G::KB, STAGES = G::STAGES;
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem + G::AREA;
  const int warp = warp_index(), lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * ROWS;
  const int ekb = (pad_f(p.F) + 63) / 64;  // the embedding's 64-deep blocks
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int role = warpgroup_index();
  if (role == 2) {  // the producer: every tile of the chain, in the consumers' order
    reg_dealloc<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      RingPos at;
      auto put = [&](const CUtensorMap* m, int k0, int n0) {
        mbar_wait(&empty[at.stage], at.phase ^ 1);
        unsigned char* sb = ring + at.stage * G::STAGE;
        mbar_expect_tx(&full[at.stage], G::STAGE);
        for (int pl = 0; pl < G::PLANES; ++pl)
          tma_load(sb + pl * TC_TILE, &m[pl], k0, n0, &full[at.stage]);
        at.advance<STAGES>();
      };
      if (!POST)
        for (int kb = 0; kb < ekb; ++kb)
          for (int h = 0; h < NH; ++h) put(mp.wx, 64 * kb, 128 * h);
      for (int c = 0; c < KB; ++c) {
        for (int kb = 0; kb < KB; ++kb) put(mp.w12, 64 * kb, 128 * c);
        for (int h = 0; h < NH; ++h) put(mp.w3, 64 * c, 128 * h);
      }
      if (POST)
        for (int kb = 0; kb < KB; ++kb) put(mp.wx, 64 * kb, 0);
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  const int wg = role, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int lr = 64 * wg + 16 * wq + g;  // the thread's rows of the tile: lr and lr + 8
  const int ra = row0 + lr, rb = ra + 8;
  RingPos at;
  int prev = -1;
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  // the biases into L1 once, a 128-byte line a thread: the gate reads
  // b12 after each wait on the tensor cores, where L2's latency would stall
  // it every chunk
  {
    const int line = 32 * (int)threadIdx.x;
    if (line < 2 * D) prefetch_l1(p.b12 + line);
    else if (line < 3 * D) prefetch_l1(p.b3 + line - 2 * D);
    else if (line < 4 * D && line - 3 * D < (POST ? p.F : D)) prefetch_l1(p.bx + line - 3 * D);
  }
  // the group's planes of the activation, k block 0 (its rows 128 bytes each)
  const uint32_t abase = smem_u32(smem) + 64 * wg * 128;
  // split v (the accumulators' layout, see quad_token_norm) into the
  // activation's planes in shared memory
  auto put_planes = [&](const float(&v)[NH][64]) {
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t hi, lo;
          split2(v[h][4 * jj + 2 * r], v[h][4 * jj + 2 * r + 1], hi, lo);
          const uint32_t o = swizzled(lr + 8 * r, 128 * h + 8 * jj + 2 * t, ROWS);
          *reinterpret_cast<uint32_t*>(smem + o) = hi;
          if (PASSES == 3) *reinterpret_cast<uint32_t*>(smem + G::AP + o) = lo;
        }
  };

  if constexpr (!POST) {
    // e = x Wemb: x's fragments from device memory, 64 columns at a time;
    // each 64-deep block a chain of its own, the two added in float32 (the
    // five-launch form's two accumulators), the first parked in the planes'
    // area, which n's planes take only after both groups read it back
    float* park = reinterpret_cast<float*>(smem);
    float e[NH][64];
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) e[h][i] = 0.f;
    for (int kb = 0; kb < ekb; ++kb) {
      uint32_t fh[4][4], fl[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int row = (h & 1) ? rb : ra, col = 64 * kb + 16 * s + 8 * (h >> 1) + 2 * t;
          float2 v = make_float2(0.f, 0.f);
          if (row < p.M && col < p.F)  // F is a multiple of 4: col + 1 < F too
            v = __ldg(reinterpret_cast<const float2*>(p.x + (size_t)row * p.F + col));
          split2(v.x, v.y, fh[s][h], fl[s][h]);
        }
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        mbar_wait(&full[at.stage], at.phase);
        const uint32_t sb = smem_u32(ring + at.stage * G::STAGE);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          wgmma_rs128(e[h], fh[s], desc_k(sb + s * 32));
          if (PASSES == 3) {
            wgmma_rs128(e[h], fh[s], desc_k(sb + TC_TILE + s * 32));
            wgmma_rs128(e[h], fl[s], desc_k(sb + s * 32));
          }
        }
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          release(prev);
        }
        prev = at.stage;
        at.advance<STAGES>();
      }
      wgmma_wait<0>();  // the fragments are rewritten for the next block
      release(prev);
      prev = -1;
      if (kb == 0 && ekb == 2) {  // the first block's chain of sums aside
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          fence_acc(e[h]);
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            park[(64 * h + i) * CONSUMER_WARPS * 32 + threadIdx.x] = e[h][i];
            e[h][i] = 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      fence_acc(e[h]);
      if (ekb == 2)
#pragma unroll
        for (int i = 0; i < 64; ++i)
          e[h][i] = park[(64 * h + i) * CONSUMER_WARPS * 32 + threadIdx.x] + e[h][i];
    }
    // a thread's parked sums lie across both groups' rows of the planes:
    // every consumer has read its sums back before any writes n's planes
    if (ekb == 2) consumers_sync();
    // e + bemb, written where asked; n = token_norm(e) [doubled] + pe
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int c = 128 * h + 8 * jj + 2 * t;
        const float2 b = __ldg(reinterpret_cast<const float2*>(p.bx + c));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          e[h][4 * jj + 2 * r] += b.x;
          e[h][4 * jj + 2 * r + 1] += b.y;
        }
      }
    if (p.emb != nullptr) {
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r ? rb : ra, c = 128 * h + 8 * jj + 2 * t;
            const float2 v = make_float2(e[h][4 * jj + 2 * r], e[h][4 * jj + 2 * r + 1]);
            if (row < p.M) *reinterpret_cast<float2*>(p.emb + (size_t)row * D + c) = v;
          }
    }
    quad_token_norm<NH, true>(e);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* pr = p.pe + (size_t)(((r ? rb : ra)) % p.T) * D;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const float2 pv = __ldg(reinterpret_cast<const float2*>(pr + 128 * h + 8 * jj + 2 * t));
          float& n0 = e[h][4 * jj + 2 * r];
          float& n1 = e[h][4 * jj + 2 * r + 1];
          n0 = (p.pe_residual ? n0 + n0 : n0) + pv.x;
          n1 = (p.pe_residual ? n1 + n1 : n1) + pv.y;
        }
    }
    put_planes(e);
  } else {
    // the decoded rows' planes, whole rows a warp, RU rows' loads in flight
    constexpr int RU = 4;
    for (int r0 = warp; r0 < ROWS; r0 += RU * CONSUMER_WARPS) {
      float4 v[RU][TN / 4];
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int row = row0 + r0 + u * CONSUMER_WARPS;
#pragma unroll
        for (int q4 = 0; q4 < TN / 4; ++q4)
          v[u][q4] = row < p.M ? __ldg(reinterpret_cast<const float4*>(
                                     p.x + (size_t)row * D + col_of(4 * q4)))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < RU; ++u)
#pragma unroll
        for (int q4 = 0; q4 < TN / 4; ++q4) {
          uint32_t h0, l0, h1, l1;
          split2(v[u][q4].x, v[u][q4].y, h0, l0);
          split2(v[u][q4].z, v[u][q4].w, h1, l1);
          const uint32_t o = swizzled(r0 + u * CONSUMER_WARPS, col_of(4 * q4), ROWS);
          *reinterpret_cast<uint2*>(smem + o) = make_uint2(h0, h1);
          if (PASSES == 3) *reinterpret_cast<uint2*>(smem + G::AP + o) = make_uint2(l0, l1);
        }
    }
  }
  fence_proxy_async();
  consumers_sync();

  // the SwiGLU body: s = g W3, chunk by chunk, onto b3 (+ f in the post
  // head: those terms load before the products, not beside s's sums after
  // them, where they spilled)
  float s[NH][64];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? rb : ra, c = 128 * h + 8 * jj + 2 * t;
        float2 v = __ldg(reinterpret_cast<const float2*>(p.b3 + c));
        if (POST && row < p.M) {
          const float2 fv = __ldg(reinterpret_cast<const float2*>(p.f + (size_t)row * D + c));
          v = make_float2(v.x + fv.x, v.y + fv.y);
        }
        s[h][4 * jj + 2 * r] = v.x;
        s[h][4 * jj + 2 * r + 1] = v.y;
      }
  for (int c = 0; c < KB; ++c) {
    // [x1 | x2] of the chunk: KB stages of 4 steps of 16
    float u[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) u[i] = 0.f;
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      mbar_wait(&full[at.stage], at.phase);
      const uint32_t sb = smem_u32(ring + at.stage * G::STAGE);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t a = abase + kb * ROWS * 128 + q * 32, b = sb + q * 32;
        wgmma_ss128<0, 0>(u, desc_k(a), desc_k(b));
        if (PASSES == 3) {
          wgmma_ss128<0, 0>(u, desc_k(a), desc_k(b + TC_TILE));
          wgmma_ss128<0, 0>(u, desc_k(a + G::AP), desc_k(b));
        }
      }
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();
        release(prev);
      }
      prev = at.stage;
      at.advance<STAGES>();
    }
    wgmma_wait<0>();
    fence_acc(u);
    release(prev);
    prev = -1;
    // s += g W3[64 c .. 64 c + 63, :] (its NH 128-column halves, a stage
    // each), one 16-deep step q at a time: g = (x1 + b1) * sigmoid(x2 +
    // b2) for the step's columns, split into its A fragments (accumulator
    // pair (g or g + 8, 16 q + 8 (h / 2) + 2 t) is fragment register h;
    // x2 sits 64 columns, 32 accumulators, after x1), then the step's
    // products issue and run while the next step is gated
    uint32_t sb3[NH];
    int st3[NH];
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      mbar_wait(&full[at.stage], at.phase);
      sb3[h] = smem_u32(ring + at.stage * G::STAGE);
      st3[h] = at.stage;
      at.advance<STAGES>();
    }
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int i = 8 * q + 2 * h, col = 64 * c + 16 * q + 8 * (h >> 1) + 2 * t;
        const float2 b1 = __ldg(reinterpret_cast<const float2*>(p.b12 + col));
        const float2 b2 = __ldg(reinterpret_cast<const float2*>(p.b12 + D + col));
        const float g0 = (u[i] + b1.x) * sigmoid_nr(u[i + 32] + b2.x);
        const float g1 = (u[i + 1] + b1.y) * sigmoid_nr(u[i + 33] + b2.y);
        split2(g0, g1, ah[q][h], al[q][h]);
      }
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        wgmma_rs128(s[h], ah[q], desc_k(sb3[h] + q * 32));
        if (PASSES == 3) {
          wgmma_rs128(s[h], ah[q], desc_k(sb3[h] + TC_TILE + q * 32));
          wgmma_rs128(s[h], al[q], desc_k(sb3[h] + q * 32));
        }
      }
      wgmma_commit();
    }
    wgmma_wait<0>();  // the fragments are rewritten for the next chunk
#pragma unroll
    for (int h = 0; h < NH; ++h) release(st3[h]);
  }
#pragma unroll
  for (int h = 0; h < NH; ++h) fence_acc(s[h]);

  if constexpr (!POST) {
    // s out
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r ? rb : ra, c = 128 * h + 8 * jj + 2 * t;
          const float2 v = make_float2(s[h][4 * jj + 2 * r], s[h][4 * jj + 2 * r + 1]);
          if (row < p.M) *reinterpret_cast<float2*>(p.out + (size_t)row * D + c) = v;
        }
  } else {
    // z = token_norm(s), s = (b3 + f) + g W3 here; z * sigmoid(z)
    quad_token_norm<NH, false>(s);
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) s[h][i] = s[h][i] * sigmoid_nr(s[h][i]);
    // z's planes where the decoded rows' were: the group's products that
    // read them are done (each warp waited for them before the W3 products,
    // which the whole group issues)
    put_planes(s);
    fence_proxy_async();
    consumers_sync();
    // out = z Wh: Wh^T's FP <= 128 rows as one m64n128 sum (zero past FP)
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      mbar_wait(&full[at.stage], at.phase);
      const uint32_t sb = smem_u32(ring + at.stage * G::STAGE);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t a = abase + kb * ROWS * 128 + q * 32, b = sb + q * 32;
        wgmma_ss128<0, 0>(o, desc_k(a), desc_k(b));
        if (PASSES == 3) {
          wgmma_ss128<0, 0>(o, desc_k(a), desc_k(b + TC_TILE));
          wgmma_ss128<0, 0>(o, desc_k(a + G::AP), desc_k(b));
        }
      }
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();
        release(prev);
      }
      prev = at.stage;
      at.advance<STAGES>();
    }
    wgmma_wait<0>();
    fence_acc(o);
    release(prev);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int c = 8 * jj + 2 * t;
      const bool in = c < p.F;  // F is a multiple of 4: c + 1 < F too
      const float2 b =
          in ? __ldg(reinterpret_cast<const float2*>(p.bx + c)) : make_float2(0.f, 0.f);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? rb : ra;
        const float2 v = make_float2(o[4 * jj + 2 * r] + b.x, o[4 * jj + 2 * r + 1] + b.y);
        if (in && row < p.M) *reinterpret_cast<float2*>(p.out + (size_t)row * p.F + c) = v;
      }
    }
  }
}

// ---- the launch sequence (D = 384, 512) --------------------------------------

// The pre chain's row step: n = token_norm(e) (+ token_norm(e) with
// pe_residual) + pe[row % T], as hi / lo planes (row stride D = 32 TN).
template <int TN>
__global__ void __launch_bounds__(NT)
    pre_norm_kernel(const float* __restrict__ e, const float* __restrict__ pe, int M, int T,
                    int pe_residual, bf16* __restrict__ hi, bf16* __restrict__ lo) {
  constexpr int D = 32 * TN;
  const int row0 = blockIdx.x * BM;
  float v[TM][TN];
  load_rows<TN>(v, e, D, row0, M);
  row_norm<TN>(v);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + row_of(i);
    if (row >= M) continue;
    const float* pr = pe + (size_t)(row % T) * D;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float n = v[i][j];
      v[i][j] = (pe_residual ? n + n : n) + __ldg(pr + col_of(j));
    }
  }
  store_planes<TN>(hi, lo, row0, M, v);
}

// The post head's row step: z = token_norm(r), z * sigmoid(z), as hi / lo
// planes (row stride D = 32 TN).
template <int TN>
__global__ void __launch_bounds__(NT)
    post_norm_kernel(const float* __restrict__ r, int M, bf16* __restrict__ hi,
                     bf16* __restrict__ lo) {
  constexpr int D = 32 * TN;
  const int row0 = blockIdx.x * BM;
  float v[TM][TN];
  load_rows<TN>(v, r, D, row0, M);
  row_norm<TN>(v);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) v[i][j] = v[i][j] * sigmoidf(v[i][j]);
  store_planes<TN>(hi, lo, row0, M, v);
}

}  // namespace kit

namespace {

#define KIT_CHECK(x) \
  if ((rc = (x)) != 0) return rc

struct SwiGluW {  // [W1 | W2]^T (2D, D) interleaved and W3^T (D, D) planes
  const bf16 *w12h, *w12l, *w3h, *w3l;
  const float *b12, *b3;
};

// The one-launch chain at D = 32 TN <= 256 (see the note at the top); wxh
// / wxl: Wemb^T (D, FP) for the pre chain, Wh^T (FP, D) for the post head.
template <int TN, int PASSES, bool POST>
int chain_tc(const SwiGluW& w, const bf16* wxh, const bf16* wxl, const ChainArgs& a,
             cudaStream_t st) {
  using G = ChainTc<TN, PASSES>;
  constexpr int D = G::D;
  static bool ready = false;
  cudaError_t e = allow_smem(chain_tc_kernel<TN, PASSES, POST>, G::SMEM, ready);
  if (e != cudaSuccess) return (int)e;
  const int FP = pad_f(a.F);
  ChainMaps mp;
  int rc;
  const bf16* lo[3] = {PASSES == 3 ? w.w12l : nullptr, PASSES == 3 ? w.w3l : nullptr,
                       PASSES == 3 ? wxl : nullptr};
  KIT_CHECK(plane_map(&mp.w12[0], w.w12h, 2 * D, D, 128));
  KIT_CHECK(plane_map(&mp.w12[1], lo[0], 2 * D, D, 128));
  KIT_CHECK(plane_map(&mp.w3[0], w.w3h, D, D, 128));
  KIT_CHECK(plane_map(&mp.w3[1], lo[1], D, D, 128));
  KIT_CHECK(plane_map(&mp.wx[0], wxh, POST ? FP : D, POST ? D : FP, 128));
  KIT_CHECK(plane_map(&mp.wx[1], lo[2], POST ? FP : D, POST ? D : FP, 128));
  chain_tc_kernel<TN, PASSES, POST><<<(a.M + G::ROWS - 1) / G::ROWS, WG_THREADS, G::SMEM, st>>>(
      mp, a);
  return (int)cudaGetLastError();
}

// g = (n W1 + b1) * sigmoid(n W2 + b2) from n's planes into g's.
template <int PASSES>
int gate(Planes n, int M, int D, const SwiGluW& w, Planes gp, cudaStream_t st) {
  GemmArgs p{};
  p.oh = gp.hi;
  p.ol = gp.lo;
  p.bias = w.b12;
  p.ldo = D;
  return project<PASSES, EPI_GLU, 0>(n.hi, n.lo, M, D, w.w12h, w.w12l, 2 * D, D, p, st);
}

// x (M, F) -> s (M, D) and e (M, D) in five launches.  planes: M (FP + 2
// D) bf16 a plane.
template <int TN, int PASSES>
int pre_embed(const float* x, int M, int T, int F, const bf16* wembh, const bf16* wembl,
              const float* bemb, const float* pe, const SwiGluW& w, float* out, float* emb,
              int pe_residual, bf16* planes, cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int FP = pad_f(F);
  bf16* cur = planes;
  const Planes xp = carve<PASSES>(cur, (size_t)M * FP), np = carve<PASSES>(cur, (size_t)M * D),
               gp = carve<PASSES>(cur, (size_t)M * D);
  int rc;
  KIT_CHECK(split_rows(x, M, F, FP, xp.hi, xp.lo, st));
  GemmArgs pe_args{};
  pe_args.out = emb;
  pe_args.ldo = D;
  pe_args.bias = bemb;
  KIT_CHECK((project<PASSES, EPI_BIAS, 0>(xp.hi, xp.lo, M, FP, wembh, wembl, D, FP, pe_args, st)));
  pre_norm_kernel<TN><<<(M + BM - 1) / BM, NT, 0, st>>>(emb, pe, M, T, pe_residual, np.hi, np.lo);
  KIT_CHECK((int)cudaGetLastError());
  KIT_CHECK(gate<PASSES>(np, M, D, w, gp, st));
  GemmArgs so{};
  so.out = out;
  so.ldo = D;
  so.bias = w.b3;
  return project<PASSES, EPI_BIAS, 0>(gp.hi, gp.lo, M, D, w.w3h, w.w3l, D, D, so, st);
}

// decoded, f (M, D) -> out (M, F) in five launches.  planes: 3 M D bf16 a
// plane; fs: M D floats.
template <int TN, int PASSES>
int post_head(const float* dec, const float* f, int M, const SwiGluW& w, const bf16* whh,
              const bf16* whl, const float* bh, int F, float* out, bf16* planes, float* fs,
              cudaStream_t st) {
  constexpr int D = 32 * TN;
  const size_t MD = (size_t)M * D;
  bf16* cur = planes;
  const Planes dp = carve<PASSES>(cur, MD), gp = carve<PASSES>(cur, MD),
               zp = carve<PASSES>(cur, MD);
  int rc;
  KIT_CHECK(split_planes(dec, MD, dp.hi, dp.lo, st));
  KIT_CHECK(gate<PASSES>(dp, M, D, w, gp, st));
  KIT_CHECK((project<PASSES, EPI_RES, 0>(gp.hi, gp.lo, M, D, w.w3h, w.w3l, D, D,
                                         res_out(fs, D, f, w.b3), st)));
  post_norm_kernel<TN><<<(M + BM - 1) / BM, NT, 0, st>>>(fs, M, zp.hi, zp.lo);
  KIT_CHECK((int)cudaGetLastError());
  // the head's planes (FP, D), its rows past F zero; out's rows F wide
  GemmArgs ho{};
  ho.M = M;
  ho.N = F;
  ho.K = D;
  ho.out = out;
  ho.ldo = F;
  ho.bias = bh;
  return tc_gemm_ld<PASSES, 0, EPI_BIAS, 0>(zp.hi, zp.lo, M, D, D, whh, whl, pad_f(F), D, D, ho,
                                            1, st);
}

#undef KIT_CHECK

bool mode_ok(int passes, const SwiGluW& w, const void* lo) {
  if (passes == 1) return true;
  return passes == 3 && w.w12l != nullptr && w.w3l != nullptr && lo != nullptr;
}

SwiGluW swiglu_w(const void* w12h, const void* w12l, const void* b12, const void* w3h,
                 const void* w3l, const void* b3) {
  return SwiGluW{(const bf16*)w12h, (const bf16*)w12l, (const bf16*)w3h,
                 (const bf16*)w3l,  (const float*)b12, (const float*)b3};
}

}  // namespace

// x (M, F) -> out (M, D) and emb (M, D): the pre-stream chain in mode
// passes (3 "high", 1 "default").  wembh / wembl: Wemb^T (D, FP) planes,
// its columns past F zero (FP = F rounded up to 16); w12h / w12l: [W1 |
// W2]^T (2D, D) planes, their rows interleaved per 64 (W1's columns 64 j ..
// 64 j + 63, then W2's); w3h / w3l: W3^T (D, D) planes (the lo planes null
// with passes 1); bemb (D), b12 = [b1 | b2] (2D) as it is, b3 (D); pe (T,
// D) the positional table plus the learned vector, row m reading pe[m %
// T].  D is 128, 256, 384 or 512, F <= D a multiple of 4.  The caller
// picks the form: planes null runs the one-launch kernel (D <= 256 and F
// <= 128 only; emb null: e not written); else the five-launch sequence,
// planes M (FP + 2D) bf16 a plane and emb (read back) not null.
extern "C" int kit_pre_embed_tc(int passes, const void* x, int M, int T, int F, int D,
                                const void* wembh, const void* wembl, const void* bemb,
                                const void* pe, const void* w12h, const void* w12l,
                                const void* b12, const void* w3h, const void* w3l,
                                const void* b3, void* out, void* emb, int pe_residual,
                                void* planes, void* stream) {
  const SwiGluW w = swiglu_w(w12h, w12l, b12, w3h, w3l, b3);
  const bool one = planes == nullptr;
  if (!mode_ok(passes, w, wembl) || F % 4 || F > D || (one && (D > 256 || F > 128)) ||
      (!one && emb == nullptr))
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return by_width(D, [&](auto tn) {
    constexpr int TN = decltype(tn)::value;
    if constexpr (TN <= 8) {
      if (one) {
        ChainArgs a{};
        a.x = (const float*)x;
        a.M = M;
        a.T = T;
        a.F = F;
        a.pe_residual = pe_residual;
        a.bx = (const float*)bemb;
        a.pe = (const float*)pe;
        a.b12 = w.b12;
        a.b3 = w.b3;
        a.out = (float*)out;
        a.emb = (float*)emb;
        auto fn = passes == 3 ? chain_tc<TN, 3, false> : chain_tc<TN, 1, false>;
        return fn(w, (const bf16*)wembh, (const bf16*)wembl, a, st);
      }
    }
    auto fn = passes == 3 ? pre_embed<TN, 3> : pre_embed<TN, 1>;
    return fn((const float*)x, M, T, F, (const bf16*)wembh, (const bf16*)wembl,
              (const float*)bemb, (const float*)pe, w, (float*)out, (float*)emb, pe_residual,
              (bf16*)planes, st);
  });
}

// decoded, filled_emb (M, D) -> out (M, F): the post head in mode passes.
// w12 / w3 planes and biases as kit_pre_embed_tc takes them; whh / whl: Wh^T
// (FP, D) planes, its rows past F zero; bh (F).  The form as there: planes
// and fs null run the one-launch kernel (D <= 256 and F <= 128 only); else
// the five-launch sequence, planes 3 M D bf16 a plane and fs M D floats.
extern "C" int kit_post_head_tc(int passes, const void* dec, const void* f, int M, int D,
                                const void* w12h, const void* w12l, const void* b12,
                                const void* w3h, const void* w3l, const void* b3,
                                const void* whh, const void* whl, const void* bh, int F,
                                void* out, void* planes, void* fs, void* stream) {
  const SwiGluW w = swiglu_w(w12h, w12l, b12, w3h, w3l, b3);
  const bool one = planes == nullptr;
  if (!mode_ok(passes, w, whl) || F % 4 || F > D || (one && (D > 256 || F > 128)) ||
      one != (fs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return by_width(D, [&](auto tn) {
    constexpr int TN = decltype(tn)::value;
    if constexpr (TN <= 8) {
      if (one) {
        ChainArgs a{};
        a.x = (const float*)dec;
        a.f = (const float*)f;
        a.M = M;
        a.F = F;
        a.bx = (const float*)bh;
        a.b12 = w.b12;
        a.b3 = w.b3;
        a.out = (float*)out;
        auto fn = passes == 3 ? chain_tc<TN, 3, true> : chain_tc<TN, 1, true>;
        return fn(w, (const bf16*)whh, (const bf16*)whl, a, st);
      }
    }
    auto fn = passes == 3 ? post_head<TN, 3> : post_head<TN, 1>;
    return fn((const float*)dec, (const float*)f, M, w, (const bf16*)whh, (const bf16*)whl,
              (const float*)bh, F, (float*)out, (bf16*)planes, (float*)fs, st);
  });
}
