// The feed-forward sublayer of the transformer: forward (one launch) and
// backward, in the precision modes "highest" (float32), "high" (bf16x3) and
// "default" (one bf16 pass), and int8 for serving.
//
// Replaces keypoints_interpolation_transformer_tpu/ops/pallas/ffn.py:
//   * _kernel_single (with want_residuals for training):
//         x1 = LN1(r) if pre_ln else r
//         u  = x1 W1 + b1;  h = gelu(u) (exact erf);  z = x1 + (h W2 + b2)
//         y  = LN2(z)         [training also writes u (M, FF) and z (M, D)]
//   * _ffn_bwd_kernel (has_uz): from r, g = dL/dy, u, z and the weights,
//         dz = LN2'(g);  dW2 = h^T dz;  db2 = sum dz;  du = (dz W2^T) gelu'(u)
//         dW1 = x1^T du;  db1 = sum du;  dx1 = du W1^T + dz;  dr = LN1'(dx1)
//     and the LayerNorm gradients.
//   * _kernel_int8 (serving int8): both products int8 x int8 -> int32 with
//     per-row activation scales found in the kernel (int8.cuh::ff_int8_rows).
//
// What bounds it on an H100: float32 FFMA work.  Forward 2 * 2 * D * FF =
// 2.1 MFLOP per token at D = 256, FF = 2048 (17.2 GFLOP per call at B = 64,
// T = 128) against 2 KB per token in and out, and 10 KB more for the u / z
// residuals in training.  The backward's four products are 4.2 MFLOP per
// token (34.4 GFLOP per call); it reads u (8 KB per token) once more.
//
// Forward design (float32), on sgemm.cuh's 8 x 8 core: a block owns a tile
// of BM token rows with x1 = LN1(r) k-major in shared memory and walks the
// FF axis in chunks of FC columns: u = x1 W1[:, chunk] + b1 in registers
// (stored as the training residual on the way), gelu(u) k-major in shared
// memory, then z += gelu(u) W2[chunk, :] in registers across the chunks;
// at the end z = x1 + (z + b2) (stored in training) and y = LN2(z), the
// LayerNorms one warp a row through shared memory (g_put / get_rows).  The
// weights stream through a ring of cp.async tiles; at FC = D the W1 and
// W2 products of a chunk and the next chunk's W1 chain on it, so the next
// tiles load during each product's last steps and the GELU.  It is
// layer_fused.cu's FF tail without the attention, and two builds cover the
// rows:
//   * the row tile (row_tile(D): 64 rows at D <= 256, 32 above; FC = D;
//     two BM x D accumulators, 128 registers a thread at D = 256, one
//     block an SM) wherever those tiles fill half the card
//     (rows_fill: B = 64 and 256 at T = 128);
//   * below that (one 128-frame video, the 600-frame request) the FF
//     split: FF_SPLIT_ROWS-row tiles whose FF_SPLIT_COLS-wide chunks are
//     shared by `parts` blocks (ff_parts in ops/kernels/ffn.py: about two
//     blocks an SM); each block computes LN1 of its tile itself, sums its
//     contiguous share of the chunks into scratch (parts x M x D), and a
//     second pass (ffn_finish_kernel, one warp a row) adds the parts in
//     order, then x1 and b2, writes z and applies LN2.  No atomics: the
//     same inputs give the same bits.  The W1 product of a narrow chunk
//     reads each ring slot as FC-wide tiles D / FC times deeper, so both
//     products share the slots; they do not chain (their tiles differ).
// What bounds it on an H100: the products' shared-memory reads (16 floats
// a step for 64 FFMAs at 8 x 8: about 65 % of the FFMA peak, sgemm.cuh)
// where the rows fill the card; at small M the parallelism (16 row-chunk
// items of 64 x D at M = 128 without the split, 64 blocks with it) and
// the split's scratch round trip.  GELU uses erff: the rational erf of the
// TPU kernel exists only because Mosaic has no erf.
//
// Backward design (float32).  The TPU kernel walks row cells in order and
// keeps the (D, FF) weight-gradient sums in VMEM from one cell to the
// next; blocks on Hopper run in parallel and a block's 227 KB cannot hold
// a 2 MB sum.  The two consumers of du also contract over different axes:
// dx1 over FF (a row's own reduction) and dW1 over the rows.  So du is
// written once (N x FF, 67 MB at the flagship: about 0.04 ms of traffic
// against 0.5 ms of products) and the backward runs its four products on
// sgemm.cuh's 8 x 8 core (sgemm_grad.cuh), with no work beyond the
// function's own:
//   A. ln_bwd: dz from g and z (one warp per row), per-block sums of g n2
//      and g; du = (dz W2^T) gelu'(u) (nnr: a 64-row tile of dz stays in
//      shared memory while W2^T's column tiles stream, each with its tile
//      of u landing for the epilogue), and dz's column sums (db2) from the
//      same tile;
//   B. with pre_ln, x1 = LN1(r); [dW1^T | dW2^T] = [du^T x1 | gelu(u)^T
//      dz] in one launch (tn, over row ranges; gelu(u) as its tile is
//      staged, the dW2 sums stored transposed, du's column sums, db1, on
//      the way); dx1 = du W1^T + dz (nn); with pre_ln, dr = LN1'(dx1) in
//      place.
// Every partial sum (row ranges, row tiles, the LayerNorms' 32-row blocks)
// is added in a fixed order (sum_split): no atomics, so every gradient has
// the same bits from run to run.  Gradients come out in torch's Linear
// layout (dW1^T (FF, D), dW2^T (D, FF)), which is also the layout of the
// weights the products read.
//
// The precision modes (mma_bf16.cuh: wgmma fed by TMA through an mbarrier
// ring, a producer warpgroup and two consumer warpgroups a block):
//   * _kernel_split ("high", bf16x3) and _kernel_single's bf16 mode
//     ("default") -> ffn_tc_kernel<TN, PASSES>: the forward above on the
//     bf16 tensor cores.  A block owns 128 token rows (64 a group; above D
//     = 256 both groups take the same 64 rows and split z's columns, since
//     64 x D sums no longer fit a group's registers, each computing u
//     itself); x1 = LN1(r) is split once into hi / lo planes in shared
//     memory, in the layout the product reads.  The FF axis is walked in
//     64-wide chunks: u = x1 W1 + b1 (m64n64 products, K-major operands
//     from shared memory) stays in registers, is stored for training, goes
//     through the GELU and is split into hi / lo bf16 A fragments in
//     registers (the m64nN accumulator is laid out as the A fragment, as
//     FlashAttention-3 feeds P), which feed z += h W2 (m64n128 products, A
//     from registers), z held in registers across the chunks.  The weights
//     arrive pre-split in torch's layout (W1^T (FF, D), W2^T (D, FF): k
//     contiguous, the K-major operands), once per packed model for serving
//     and once per step in training, and stream through the ring by TMA:
//     no weight load stands between two barriers of the consumers.  LN1,
//     LN2, GELU (erff), the biases and the residual stay float32; the
//     epilogue parks z + b2 in shared memory and recomputes x1 = LN1(r)
//     per row.  Where the 128-row tiles fill less than half the card (the
//     A1 step's 8192 rows give 64; one 128-frame video 1), the FF chunks of
//     a tile are split over tc_parts blocks and ffn_finish_kernel adds the
//     parts in order, as in float32.  Bound: 2.1 MFLOP per token at the
//     flagship (times 3 for "high") over 989 TFLOP/s, and each block reads
//     all of W1 and W2 (4 MB of planes at "high") from L2: 128 rows a block
//     halve that traffic against 64.
//   * _ffn_bwd_kernel_a / _ffn_bwd_kernel_b (the two-kernel backward) ->
//     kit_ffn_bwd_split: phase A, LN2 backward (ln_bwd, which also writes
//     dz's planes), du = (dz W2^T) gelu'(u) written once in float32 and as
//     planes, its epilogue also writing gelu(u)'s planes (one erf of u for
//     both) and du's column sums per row tile (db1), dW2^T = dz^T gelu(u),
//     db2; phase B, x1's planes (ln_fwd, or split_kernel from r), dW1^T =
//     du^T x1, dx1 = du W1^T + dz, LN1 backward.  The four products run on
//     one core, tc_gemm_kernel: 128 x 128 output tiles, 64-deep stages
//     through the same TMA ring, the operands bf16 planes in device memory
//     written once, alternate stages summed into two accumulators (a long
//     chain of tensor-core float32 sums drifts: see the kernel); the two
//     weight-gradient products contract over token rows and read dz, du,
//     gelu(u) and x1 MN-major, as they lie, with no transpose; the weights
//     are the forward's planes (MN-major here).  The weight gradients sum
//     over row ranges (tc_bwd_splits in the wrapper, a multiple of 64 rows
//     each), every partial sum added by sum_split in a fixed order: no
//     atomics, the same bits from run to run.  Bound: 4.2 MFLOP per token
//     (times 3 for "high") over 989 TFLOP/s, and the du product's epilogue
//     moves 12 bytes of u, du and planes per element.  In float32 the same
//     phases are the backward above.
#include <algorithm>

#include "common.cuh"
#include "grad.cuh"
#include "int8.cuh"
#include "mma_bf16.cuh"
#include "sgemm_grad.cuh"

using namespace kit;

namespace {

// The FF split's build (see the note at the top): row tiles and FF chunks.
constexpr int FF_SPLIT_ROWS = 32;
constexpr int FF_SPLIT_COLS = 128;
// The tensor-core forward's FF chunk (the N of its u product).
constexpr int FC_TC = 64;

// The arguments of the float32 forward (kit_ffn): r (M, D) -> y (M, D);
// u (M, FF) and z (M, D) when not null; g1 null: no LN1; with parts > 1,
// partial holds parts x M x D floats.
struct FfArgs {
  const float* r;
  int M, n, FF, parts;
  const float *w1, *b1, *w2, *b2, *g1, *be1, *g2, *be2;
  float *y, *u, *z, *partial;
};

// The geometry of a forward build: BM token rows a block, the FF axis in
// chunks of FC columns.  Shared memory: x1 (D x LDA, k-major), one GELU
// chunk (FC x LDA), then the weight ring of STAGES tiles of DEPTH x D
// floats, which the W1 product reads as DEPTH1 x FC.
template <int TN, int BM_, int FC_>
struct FfGeo {
  static constexpr int D = 32 * TN, BM = BM_, FC = FC_;
  static constexpr int LDA = BM + 4;  // keeps 16-byte rows and 4 LDA = 16 mod 32
  // the row-tile build up to D = 256 streams 32-deep tiles in two stages
  // (half the barriers of sgemm.cuh's three stages of BK: 2-3 % faster on
  // an H100, layer_probe.py forwards); the others sgemm.cuh's ring
  static constexpr bool DEEP = FC == D && D <= 256;
  static constexpr int STAGES = DEEP ? 2 : ring_stages(D);
  static constexpr int DEPTH = DEEP ? 2 * BK : BK;  // W2 product: N = D
  static constexpr int DEPTH1 = DEPTH * D / FC;     // W1 product: N = FC, the same tile
  static constexpr int RM = BM / 8;           // rows a warp in the LayerNorm layout
  static constexpr bool CHAIN = FC == D;      // the products share one tile shape
  // two blocks an SM for the split's narrow tiles up to D = 256
  static constexpr int MIN_BLOCKS = BM * FC < 64 * D && D <= 256 ? 2 : 1;
  static constexpr int SMEM = (D * LDA + FC * LDA + STAGES * DEPTH * D) * (int)sizeof(float);
};

// acc += AT cur on the weight ring at pos (block_mma), cur's tiles in
// flight if primed; next, a product of the same shape (or W null), loads
// from cur's last steps on if it can chain.  Returns whether next is
// primed.
template <int BM, int N, int LDA, int DEPTH, int STAGES>
__device__ __forceinline__ bool ring_mma(float (&acc)[BM / 8][N / 32], const float* AT,
                                         const Wt& cur, const Wt& next, float* buf, int& pos,
                                         bool primed) {
  using R = Ring<N, DEPTH, STAGES>;
  R ring{buf, pos};
  const Wt nx = R::chainable(next) ? next : Wt{};
  if (!primed) ring.start(cur, nx);
  block_mma<BM, N, LDA, DEPTH, STAGES>(acc, AT, cur, nx, ring);
  pos = ring.pos;
  return nx.W != nullptr;
}

// g_store of the columns < ncols (a multiple of 4) only.
template <int BM, int N>
__device__ __forceinline__ void g_store_cols(float* out, int ldo, int row0, int M, int ncols,
                                             const float (&acc)[BM / 8][N / 32]) {
  using L = Mma<BM, N>;
#pragma unroll
  for (int i = 0; i < L::RT; ++i) {
    const int row = row0 + L::row(i);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < L::CT / 4; ++h)
      if (L::col(4 * h) < ncols)
        *reinterpret_cast<float4*>(out + (size_t)row * ldo + L::col(4 * h)) = make_float4(
            acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  }
}

// Hs = gelu(Hs) over ROWS x BM k-major values (row stride LDA), in place
// (gelu(0) = 0 keeps the zeros past a short chunk), then a barrier: a loop
// over shared memory rather than over the sums in registers, as
// layer_fused.cu's gelu_tile.
template <int ROWS, int BM, int LDA>
__device__ __forceinline__ void gelu_rows(float* Hs) {
  constexpr int Q = BM / 4;  // float4 a k-major row
  for (int e = threadIdx.x; e < ROWS * Q; e += NT) {
    float4* p = reinterpret_cast<float4*>(Hs + (e / Q) * LDA) + e % Q;
    const float4 u = *p;
    *p = make_float4(gelu(u.x), gelu(u.y), gelu(u.z), gelu(u.w));
  }
  __syncthreads();
}

// One block per (row tile blockIdx.x, part blockIdx.y): the part's share
// of the FF chunks (all of them when p.parts == 1, which also ends the
// tile; else the z sums go to the part's slice of p.partial and
// ffn_finish_kernel ends it).
template <int TN, int BM, int FC>
__global__ void __launch_bounds__(NT, (FfGeo<TN, BM, FC>::MIN_BLOCKS))
    ffn_kernel(const FfArgs p) {
  using G = FfGeo<TN, BM, FC>;
  using L = Mma<BM, G::D>;
  using L1 = Mma<BM, FC>;
  constexpr int D = G::D, LDA = G::LDA, STAGES = G::STAGES;
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;              // x1, k-major
  float* Hs = Xs + D * LDA;      // gelu(u) of one chunk, k-major
  float* ring = Hs + FC * LDA;   // the weight tiles
  const int row0 = blockIdx.x * BM, q = blockIdx.y;
  const int chunks = (p.FF + FC - 1) / FC;
  const int c_lo = q * chunks / p.parts, c_hi = (q + 1) * chunks / p.parts;
  // the products of chunk c: W1's FC columns, W2's FC rows
  auto w1 = [&](int c) {
    return c < c_hi ? Wt{p.w1 + c * FC, p.FF, min(FC, p.FF - c * FC), D} : Wt{};
  };
  auto w2 = [&](int c) { return Wt{p.w2 + (size_t)c * FC * D, D, D, min(FC, p.FF - c * FC)}; };
  int pos = 0;
  {  // W1's first tiles load while the rows stage
    Ring<FC, G::DEPTH1, STAGES> r1{ring, 0};
    const Wt nx = G::CHAIN && decltype(r1)::chainable(w2(c_lo)) ? w2(c_lo) : Wt{};
    r1.start(w1(c_lo), nx);
  }
  stage_kmajor<BM, LDA>(Xs, p.r, D, row0, p.M, D);
  __syncthreads();
  if (p.g1 != nullptr) {  // x1 = LN1(r)
    float v[G::RM][TN];
    get_rows<TN, LDA>(v, Xs);
    layer_norm<TN>(v, p.g1, p.be1, p.n);
    put_rows<TN, LDA>(Xs, v);  // each thread rewrites only what it read
    __syncthreads();
  }
  float z[BM / 8][TN];
  zero(z);
  bool primed = true;
  for (int c = c_lo; c < c_hi; ++c) {
    const int f0 = c * FC, fc = min(FC, p.FF - f0);
    float h[BM / 8][FC / 32];
    zero(h);
    primed = ring_mma<BM, FC, LDA, G::DEPTH1, STAGES>(h, Xs, w1(c), G::CHAIN ? w2(c) : Wt{},
                                                      ring, pos, primed);
    if (!G::CHAIN) {  // W2's first tiles load during the epilogue and the GELU
      Ring<D, G::DEPTH, STAGES>{ring, pos}.start(w2(c), Wt{});
      primed = true;
    }
#pragma unroll
    for (int j = 0; j < L1::CT; ++j) {
      const int col = L1::col(j);
      const float b1 = col < fc ? __ldg(p.b1 + f0 + col) : 0.f;
#pragma unroll
      for (int i = 0; i < L1::RT; ++i) h[i][j] = col < fc ? h[i][j] + b1 : 0.f;
    }
    if (p.u != nullptr) g_store_cols<BM, FC>(p.u + f0, p.FF, row0, p.M, fc, h);
    g_put<BM, FC, LDA>(Hs, h);  // u; the GELU follows in place
    __syncthreads();
    gelu_rows<FC, BM, LDA>(Hs);
    primed = ring_mma<BM, D, LDA, G::DEPTH, STAGES>(z, Hs, w2(c), G::CHAIN ? w1(c + 1) : Wt{},
                                                    ring, pos, primed);
  }
  if (p.parts > 1) {
    g_store<BM, D>(p.partial + (size_t)q * p.M * D, D, row0, p.M, z);
    return;
  }
  float x[BM / 8][TN];
  g_get<BM, D, LDA>(x, Xs);  // x1, at this thread's positions
#pragma unroll
  for (int j = 0; j < L::CT; ++j) {
    const float b2 = __ldg(p.b2 + L::col(j));
#pragma unroll
    for (int i = 0; i < L::RT; ++i) x[i][j] = x[i][j] + (z[i][j] + b2);
  }
  if (p.z != nullptr) g_store<BM, D>(p.z, D, row0, p.M, x);
  g_put<BM, D, LDA>(Xs, x);  // each thread rewrites only what it read
  __syncthreads();
  float v[G::RM][TN];
  get_rows<TN, LDA>(v, Xs);
  layer_norm<TN>(v, p.g2, p.be2, p.n);
  store_rows<TN>(p.y, D, D, row0, p.M, v);
}

// The FF split's second pass, one warp a row: z = the parts' sums added
// in order, + x1 + b2, x1 = LN1(r) again by the same expression as the
// first pass; z written when asked, y = LN2(z).
template <int TN>
__global__ void __launch_bounds__(NT) ffn_finish_kernel(const FfArgs p) {
  constexpr int D = 32 * TN;
  const int row0 = blockIdx.x * (NT / 32), row = row0 + (threadIdx.x >> 5);
  if (row >= p.M) return;  // the whole warp
  auto load = [&](float (&v)[1][TN], const float* src) {
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const float4 t = __ldcg(reinterpret_cast<const float4*>(src + col_of(4 * g)));
      v[0][4 * g] = t.x;
      v[0][4 * g + 1] = t.y;
      v[0][4 * g + 2] = t.z;
      v[0][4 * g + 3] = t.w;
    }
  };
  float x[1][TN], s[1][TN], t[1][TN];
  load(x, p.r + (size_t)row * D);
  if (p.g1 != nullptr) layer_norm<TN>(x, p.g1, p.be1, p.n);
  load(s, p.partial + (size_t)row * D);
  for (int q = 1; q < p.parts; ++q) {
    load(t, p.partial + ((size_t)q * p.M + row) * D);
#pragma unroll
    for (int j = 0; j < TN; ++j) s[0][j] += t[0][j];
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) x[0][j] = x[0][j] + (s[0][j] + __ldg(p.b2 + col_of(j)));
  if (p.z != nullptr) store_rows<TN>(p.z, D, D, row0, p.M, x);
  layer_norm<TN>(x, p.g2, p.be2, p.n);
  store_rows<TN>(p.y, D, D, row0, p.M, x);
}

// The int8 forward: x1 = LN1(r) (with g1), z = ff_int8_rows(x1), y =
// LN2(z); h (M, f.n) is the scratch ff_int8_rows keeps each row's GELU
// output in.
template <int TN>
__global__ void __launch_bounds__(NT)
ffn_int8_kernel(const float* __restrict__ r, int M, int n, const FFInt8 f,
                const float* __restrict__ g1, const float* __restrict__ be1,
                const float* __restrict__ g2, const float* __restrict__ be2,
                float* __restrict__ y, float* h) {
  constexpr int D = 32 * TN;
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;            // D x LDT
  float* Hs = smem + D * LDT;  // D x LDT
  const int row0 = blockIdx.x * BM;
  stage_rows(Xs, r, D, row0, M, D);
  __syncthreads();
  float v[TM][TN];
  get_rows<TN>(v, Xs);
  if (g1 != nullptr) {
    layer_norm<TN>(v, g1, be1, n);
    put_rows<TN>(Xs, v);  // each thread rewrites only what it read
  }
  ff_int8_rows<TN>(Xs, Hs, f, h + (size_t)row0 * f.n, f.n, min(BM, M - row0));
  get_rows<TN>(v, Xs);
  layer_norm<TN>(v, g2, be2, n);
  store_rows<TN>(y, D, D, row0, M, v);
}

// The forward in the build of BM-row tiles and FC-wide chunks, then, with
// the split, its second pass.
template <int TN, int BM, int FC>
int launch(const FfArgs& p, cudaStream_t st) {
  using G = FfGeo<TN, BM, FC>;
  static bool ready = false;
  cudaError_t e = allow_smem(ffn_kernel<TN, BM, FC>, G::SMEM, ready);
  if (e != cudaSuccess) return (int)e;
  if (p.M <= 0) return 0;
  ffn_kernel<TN, BM, FC><<<dim3((p.M + BM - 1) / BM, p.parts), NT, G::SMEM, st>>>(p);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || p.parts == 1) return rc;
  ffn_finish_kernel<TN><<<(p.M + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(p);
  return (int)cudaGetLastError();
}

template <int TN>
int launch_int8(const float* r, int M, int n, const FFInt8& f, const float* g1, const float* be1,
                const float* g2, const float* be2, float* y, float* h, cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int smem = 2 * D * LDT * sizeof(float);
  static bool ready = false;
  cudaError_t e = allow_smem(ffn_int8_kernel<TN>, smem, ready);
  if (e != cudaSuccess) return (int)e;
  ffn_int8_kernel<TN><<<(M + BM - 1) / BM, NT, smem, st>>>(r, M, n, f, g1, be1, g2, be2, y, h);
  return (int)cudaGetLastError();
}

// The float32 backward (see the note at the top).  w1t = W1^T (FF, D), w2t
// = W2^T (D, FF); scratch: blocks x 2 D (LN2 sums), blocks x 2 D (LN1),
// splits x (2 FF D + FF) ([dW1^T | dW2^T | db1] parts), ceil(M /
// resident_rows(D)) x D (db2 parts), blocks = ceil(M / 32).
template <int TN>
int launch_bwd(int n, const float* g, const float* r, const float* u, const float* z,
               const float* w1t, const float* w2t, const float* g1, const float* be1,
               const float* g2, int M, int FF, int splits, float* x1, float* dz, float* du,
               float* dr, float* dw1t, float* db1, float* dw2t, float* db2, float* ln_out,
               float* scratch, cudaStream_t st) {
  constexpr int D = 32 * TN, BR = row_tile(D);
  const int blocks = (M + BM - 1) / BM, tiles = (M + resident_rows(D) - 1) / resident_rows(D);
  const size_t FD = (size_t)FF * D;
  float* p_ln2 = scratch;                         // blocks x 2D
  float* p_ln1 = p_ln2 + (size_t)blocks * 2 * D;  // blocks x 2D
  float* p_w = p_ln1 + (size_t)blocks * 2 * D;    // splits x (2 FF D + FF)
  float* p_db2 = p_w + splits * (2 * FD + FF);    // tiles x D
  int rc;
#define KIT_CHECK(x) \
  if ((rc = (x)) != 0) return rc
  // A: dz = LN2'(g); du = (dz W2^T) gelu'(u), dz's column sums (db2)
  ln_bwd_kernel<TN><<<blocks, NT, 0, st>>>(g, z, g2, M, n, dz, p_ln2);
  KIT_CHECK((int)cudaGetLastError());
  KIT_CHECK(sum_split(p_ln2, blocks, 2 * D, 2 * D, ln_out, st));
  KIT_CHECK((nnr<resident_rows(D), 256, D>(
      NNArgs{dz, D, M, D, w2t, FF, FF, du, FF, nullptr, 0, u, FF}, p_db2, st)));
  KIT_CHECK(sum_split(p_db2, tiles, D, D, db2, st));
  // B: [dW1^T | dW2^T | db1] over the rows, dx1 = du W1^T + dz, LN1'
  const float* x1r = r;
  if (g1 != nullptr) {
    ln_fwd_kernel<TN><<<blocks, NT, 0, st>>>(r, g1, be1, M, n, x1);
    KIT_CHECK((int)cudaGetLastError());
    x1r = x1;
  }
  TNArgs w{};
  w.p[0] = TNProduct{du, FF, FF, x1r, D, 0, 0, 1, 0, 2 * FD, D};
  w.p[1] = TNProduct{u, FF, FF, dz, D, 1, 1, 0, FD, 0, FF};
  w.np = 2;
  w.K = M;
  w.ncols = D;
  w.part = p_w;
  w.split = 2 * FD + FF;
  KIT_CHECK((tn<BR, D>(w, splits, st)));
  KIT_CHECK(sum_split(p_w, splits, w.split, (int)FD, dw1t, st));
  KIT_CHECK(sum_split(p_w + FD, splits, w.split, (int)FD, dw2t, st));
  KIT_CHECK(sum_split(p_w + 2 * FD, splits, w.split, FF, db1, st));
  KIT_CHECK((nn<BR, D>(NNArgs{du, FF, M, FF, w1t, D, D, dr, D, dz, D, nullptr, 0}, st)));
  if (g1 != nullptr) {
    ln_bwd_kernel<TN><<<blocks, NT, 0, st>>>(dr, r, g1, M, n, dr, p_ln1);  // in place
    KIT_CHECK((int)cudaGetLastError());
    KIT_CHECK(sum_split(p_ln1, blocks, 2 * D, 2 * D, ln_out + 2 * D, st));
  }
#undef KIT_CHECK
  return 0;
}

// ---- the precision modes "high" and "default" ------------------------------

// One token row of width D = 32 * TN as a warp holds it in the row phases
// of the tensor-core kernels: lane l has columns col_of(j), j < TN.
template <int TN>
__device__ __forceinline__ void load_row(float (&v)[TN], const float* __restrict__ src) {
#pragma unroll
  for (int q = 0; q < TN / 4; ++q) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(src + col_of(4 * q)));
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

template <int TN>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[TN]) {
#pragma unroll
  for (int q = 0; q < TN / 4; ++q)
    *reinterpret_cast<float4*>(dst + col_of(4 * q)) =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// layer_norm (common.cuh) of one row held by the warp: statistics over the
// first n columns, 0 written beyond them (gamma and beta are zero there).
template <int TN>
__device__ __forceinline__ void row_layer_norm(float (&v)[TN], const float* __restrict__ gamma,
                                               const float* __restrict__ beta, int n) {
  const float inv_n = 1.f / n;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < TN; ++j) s += col_of(j) < n ? v[j] : 0.f;
  const float mean = warp_sum(s) * inv_n;
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const float d = col_of(j) < n ? v[j] - mean : 0.f;
    ss += d * d;
  }
  const float inv = rsqrtf(warp_sum(ss) * inv_n + LN_EPS);
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = col_of(j);
    v[j] = (c < n ? (v[j] - mean) * inv : 0.f) * __ldg(gamma + c) + __ldg(beta + c);
  }
}

// The tiles of ffn_tc_kernel at D = 32 * TN in the mode's PASSES (see the
// note at the top).  Up to D = 256 the two consumer groups take 64 rows
// each (ROWS = 128) and hold z (64 x D) in registers; above, z would not
// fit, so both groups take the same 64 rows and split z's columns (group w
// the 64 columns 128 j + 64 w of each 128-wide tile j), each computing the
// chunk's u itself.  Shared memory: x1's planes (K-major,
// swizzled), then the ring of STAGES stages, each one 16 KB tile a plane:
// W1^T rows f0 .. f0 + 63 at 128 columns of D, or W2^T rows 128 j .. 128 j +
// 127 at the chunk's 64 columns of FF.  After the products z + b2 (ROWS x
// LDZ floats) reuses it all.
template <int TN, int PASSES>
struct TcFwd {
  static constexpr int D = 32 * TN;
  static constexpr bool SPLIT_D = D > 256;
  static constexpr int ROWS = SPLIT_D ? 64 : 128;
  static constexpr int PLANES = PASSES == 3 ? 2 : 1;
  static constexpr int KT = D / 128;         // stages of each product a chunk
  static constexpr int ZN = SPLIT_D ? 64 : 128;  // z's columns a group of each stage
  static constexpr int XP = ROWS * D * 2;      // bytes of one x1 plane
  static constexpr int STAGE = TC_TILE * PLANES;
  static constexpr int STAGES = cmin(MAX_STAGES, (TC_SMEM - XP * PLANES) / STAGE);
  static constexpr int LDZ = D + 8;
  static constexpr int SMEM = cmax(XP * PLANES + STAGES * STAGE, ROWS * LDZ * 4) + 1024;
  static_assert(STAGES >= 3, "a ring of at least three stages");
};

// The forward's weight planes as TMA reads them: W1^T (FF, D) in 64 x 64
// boxes, W2^T (D, FF) in 128-row x 64 boxes; [1] the lo planes.
struct FfTcMaps {
  CUtensorMap w1[2], w2[2];
};

// The forward in the mode's passes (see the note at the top) for row tile
// blockIdx.x and part blockIdx.y of p.parts (the part's share of the FF
// chunks: all of them when p.parts == 1, which also ends the tile; else the
// z sums go to the part's slice of p.partial and ffn_finish_kernel ends
// it).  p.w1 / p.w2 are unused: the weights come through the maps.
template <int TN, int PASSES>
__global__ void __launch_bounds__(WG_THREADS, 1)
    ffn_tc_kernel(const __grid_constant__ FfTcMaps mp, const FfArgs p) {
  using G = TcFwd<TN, PASSES>;
  constexpr int D = G::D, ROWS = G::ROWS, KT = G::KT, STAGES = G::STAGES;
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem + G::XP * G::PLANES;
  const int warp = warp_index(), lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * ROWS, q = blockIdx.y;
  const int chunks = (p.FF + FC_TC - 1) / FC_TC;
  const int c_lo = q * chunks / p.parts, c_hi = (q + 1) * chunks / p.parts;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int role = warpgroup_index();
  if (role == 2) {  // the producer: per chunk W1's KT stages, then W2's
    reg_dealloc<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      RingPos at;
      for (int c = c_lo; c < c_hi; ++c) {
        const int f0 = c * FC_TC;
        for (int j = 0; j < 2 * KT; ++j) {
          mbar_wait(&empty[at.stage], at.phase ^ 1);
          unsigned char* sb = ring + at.stage * G::STAGE;
          mbar_expect_tx(&full[at.stage], G::STAGE);
          for (int pl = 0; pl < G::PLANES; ++pl) {
            if (j < KT) {
              tma_load(sb + pl * TC_TILE, &mp.w1[pl], 128 * j, f0, &full[at.stage]);
              tma_load(sb + pl * TC_TILE + TC_TILE / 2, &mp.w1[pl], 128 * j + 64, f0,
                       &full[at.stage]);
            } else {
              tma_load(sb + pl * TC_TILE, &mp.w2[pl], f0, 128 * (j - KT), &full[at.stage]);
            }
          }
          at.advance<STAGES>();
        }
      }
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  const int wg = role, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int grow = G::SPLIT_D ? 0 : 64 * wg;  // the group's first row in the tile
  // x1 = LN1(r) (or r), split into its planes; rows >= M are 0
  for (int rr = warp; rr < ROWS; rr += CONSUMER_WARPS) {
    const int row = row0 + rr;
    float v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) v[j] = 0.f;
    if (row < p.M) {
      load_row<TN>(v, p.r + (size_t)row * D);
      if (p.g1 != nullptr) row_layer_norm<TN>(v, p.g1, p.be1, p.n);
    }
#pragma unroll
    for (int q4 = 0; q4 < TN / 4; ++q4) {
      uint32_t h0, l0, h1, l1;
      split2(v[4 * q4], v[4 * q4 + 1], h0, l0);
      split2(v[4 * q4 + 2], v[4 * q4 + 3], h1, l1);
      const uint32_t o = swizzled(rr, col_of(4 * q4), ROWS);
      *reinterpret_cast<uint2*>(smem + o) = make_uint2(h0, h1);
      if (PASSES == 3) *reinterpret_cast<uint2*>(smem + G::XP + o) = make_uint2(l0, l1);
    }
  }
  fence_proxy_async();
  consumers_sync();

  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  const uint32_t xa = smem_u32(smem) + grow * 128;  // the group's rows of x1, k block 0
  constexpr int ZN = G::ZN;
  float z[KT][ZN / 2];  // z's columns 128 j + (64 wg with SPLIT_D) + ...
#pragma unroll
  for (int i = 0; i < KT; ++i)
#pragma unroll
    for (int e = 0; e < ZN / 2; ++e) z[i][e] = 0.f;
  RingPos at;
  for (int c = c_lo; c < c_hi; ++c) {
    const int f0 = c * FC_TC;
    // u = x1 W1[:, chunk]: 8 steps of 16 a stage
    float u[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) u[e] = 0.f;
    int prev = -1;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      mbar_wait(&full[at.stage], at.phase);
      const uint32_t sb = smem_u32(ring + at.stage * G::STAGE);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const uint32_t a = xa + (2 * j + (s >> 2)) * ROWS * 128 + (s & 3) * 32;
        const uint32_t b = sb + (s >> 2) * (TC_TILE / 2) + (s & 3) * 32;
        wgmma_ss64<0, 0>(u, desc_k(a), desc_k(b));
        if (PASSES == 3) {
          wgmma_ss64<0, 0>(u, desc_k(a), desc_k(b + TC_TILE));
          wgmma_ss64<0, 0>(u, desc_k(a + G::XP), desc_k(b));
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
    // u += b1 (stored for training); h = gelu(u) split into the A fragments
    // of the z product: accumulator pair (g or g + 8, 16 s + 8 (h / 2) + 2 t)
    // is fragment register h of 16-deep step s (0 beyond FF)
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int i = 8 * s + 2 * h, rr = grow + 16 * wq + g + 8 * (h & 1);
        const int f = f0 + 16 * s + 8 * (h >> 1) + 2 * t;
        float h0 = 0.f, h1 = 0.f;
        if (f < p.FF) {  // FF is even: f + 1 < FF too
          const float u0 = u[i] + __ldg(p.b1 + f), u1 = u[i + 1] + __ldg(p.b1 + f + 1);
          if (p.u != nullptr && row0 + rr < p.M && (!G::SPLIT_D || wg == 0))
            *reinterpret_cast<float2*>(p.u + (size_t)(row0 + rr) * p.FF + f) =
                make_float2(u0, u1);
          h0 = gelu(u0);
          h1 = gelu(u1);
        }
        split2(h0, h1, ah[s][h], al[s][h]);
      }
    // z += h W2[chunk, :]: 4 steps of 16 a 128-column stage (the group's
    // 64 of them with SPLIT_D)
    const uint32_t zoff = G::SPLIT_D ? wg * 64 * 128 : 0;
    prev = -1;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      mbar_wait(&full[at.stage], at.phase);
      const uint32_t sb = smem_u32(ring + at.stage * G::STAGE) + zoff;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if constexpr (G::SPLIT_D) {
          wgmma_rs64(z[j], ah[s], desc_k(sb + s * 32));
          if (PASSES == 3) {
            wgmma_rs64(z[j], ah[s], desc_k(sb + TC_TILE + s * 32));
            wgmma_rs64(z[j], al[s], desc_k(sb + s * 32));
          }
        } else {
          wgmma_rs128(z[j], ah[s], desc_k(sb + s * 32));
          if (PASSES == 3) {
            wgmma_rs128(z[j], ah[s], desc_k(sb + TC_TILE + s * 32));
            wgmma_rs128(z[j], al[s], desc_k(sb + s * 32));
          }
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
    release(prev);
#pragma unroll
    for (int i = 0; i < KT; ++i) fence_acc(z[i]);
  }

  // z (+ b2 when this block ends the tile) into shared memory: value e of
  // n8 block jj of tile i is row grow + 16 wq + g (+ 8), column 128 (tile) +
  // 8 jj + 2 t (+ 1)
  consumers_sync();  // every product is done: the x1 planes and the ring are free
  float* Zs = reinterpret_cast<float*>(smem);
  const bool ends = p.parts == 1;
#pragma unroll
  for (int i = 0; i < KT; ++i) {
    const int col0 = 128 * i + (G::SPLIT_D ? 64 * wg : 0);
#pragma unroll
    for (int jj = 0; jj < ZN / 8; ++jj) {
      const int cc = col0 + 8 * jj + 2 * t;
      const float b0 = ends ? __ldg(p.b2 + cc) : 0.f, b1 = ends ? __ldg(p.b2 + cc + 1) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(Zs + (grow + 16 * wq + g + 8 * h) * G::LDZ + cc) =
            make_float2(z[i][4 * jj + 2 * h] + b0, z[i][4 * jj + 2 * h + 1] + b1);
    }
  }
  consumers_sync();
  for (int rr = warp; rr < ROWS; rr += CONSUMER_WARPS) {
    const int row = row0 + rr;
    if (row >= p.M) continue;  // the whole warp
    float v[TN];
    if (!ends) {  // the part's sums, to its slice of the scratch
#pragma unroll
      for (int j = 0; j < TN; ++j) v[j] = Zs[rr * G::LDZ + col_of(j)];
      store_row<TN>(p.partial + ((size_t)q * p.M + row) * D, v);
      continue;
    }
    // z = x1 + (h W2 + b2), x1 = LN1(r) again; y = LN2(z)
    load_row<TN>(v, p.r + (size_t)row * D);
    if (p.g1 != nullptr) row_layer_norm<TN>(v, p.g1, p.be1, p.n);
#pragma unroll
    for (int j = 0; j < TN; ++j) v[j] = v[j] + Zs[rr * G::LDZ + col_of(j)];
    if (p.z != nullptr) store_row<TN>(p.z + (size_t)row * D, v);
    row_layer_norm<TN>(v, p.g2, p.be2, p.n);
    store_row<TN>(p.y + (size_t)row * D, v);
  }
}

// The forward in the mode's passes, then, with the FF split, its second
// pass (ffn_finish_kernel, the float32 forward's).  w1h / w1l = W1^T (FF,
// D), w2h / w2l = W2^T (D, FF), the lo planes null with passes 1.
template <int TN, int PASSES>
int launch_tc(const FfArgs& p, const bf16* w1h, const bf16* w1l, const bf16* w2h,
              const bf16* w2l, cudaStream_t st) {
  using G = TcFwd<TN, PASSES>;
  constexpr int D = G::D;
  static bool ready = false;
  cudaError_t e = allow_smem(ffn_tc_kernel<TN, PASSES>, G::SMEM, ready);
  if (e != cudaSuccess) return (int)e;
  if (p.M <= 0) return 0;
  FfTcMaps mp;
  int rc;
  if ((rc = plane_map(&mp.w1[0], w1h, p.FF, D, 64)) || (rc = plane_map(&mp.w1[1], w1l, p.FF, D, 64)) ||
      (rc = plane_map(&mp.w2[0], w2h, D, p.FF, 128)) || (rc = plane_map(&mp.w2[1], w2l, D, p.FF, 128)))
    return rc;
  ffn_tc_kernel<TN, PASSES>
      <<<dim3((p.M + G::ROWS - 1) / G::ROWS, p.parts), WG_THREADS, G::SMEM, st>>>(mp, p);
  rc = (int)cudaGetLastError();
  if (rc != 0 || p.parts == 1) return rc;
  ffn_finish_kernel<TN><<<(p.M + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// ---- the split backward's products ---------------------------------------------
//
// out[m][c] (m < M, c < N) = sum over k of A(m, k) B(c, k) in the mode's
// passes, on 128 x 128 output tiles (the two groups 64 rows each) in
// 64-deep stages.  A is K-major (TA 0: (M, K) planes, 128-row boxes) or
// MN-major (TA 1: (K, M) planes, 64 x 64 boxes); B is always MN-major ((K,
// N) planes).  Split blockIdx.z of the contraction covers k in [z krows,
// (z + 1) krows) (krows a multiple of 64, so no box crosses into the next
// split) and writes at out + z * split; an empty split writes zeros.
// Epilogues: the weight-gradient parts (STORE), dx1 = product + add (ADD),
// du = product * gelu'(u) written in float32 and as hi / lo planes, with
// gelu(u)'s planes beside it (the erf of u once for both) and du's column
// sums over the tile's rows (db1's part of row tile blockIdx.y) (DU).
enum { EPI_STORE, EPI_ADD, EPI_DU };

struct GemmMaps {
  CUtensorMap a[2], b[2];
};

struct GemmArgs {
  int M, N, K, krows;
  float* out;
  int ldo;
  size_t split;
  const float* add;  // EPI_ADD: (M, N), row stride N
  const float* u;    // EPI_DU: (M, N)
  bf16 *oh, *ol;     // EPI_DU: du's planes (M, N); ol null with passes 1
  bf16 *gh, *gl;     // EPI_DU: gelu(u)'s planes (M, N); gl null with passes 1
  float* colsum;     // EPI_DU: (row tiles, N) column sums of du
};

template <int PASSES>
struct TcGemm {
  static constexpr int PLANES = PASSES == 3 ? 2 : 1;
  static constexpr int STAGE = 2 * TC_TILE * PLANES;  // A's planes, then B's
  static constexpr int STAGES = cmin(MAX_STAGES, TC_SMEM / STAGE);
  static constexpr int SMEM = STAGES * STAGE + 1024;
  static constexpr int LDC = 128 + 8;  // the output tile's row stride in the ring, floats
  static_assert(STAGES >= 3, "a ring of at least three stages");
  static_assert(128 * LDC * 4 <= STAGES * STAGE, "the output tile fits the ring");
};

template <int PASSES, int TA, int EPI>
__global__ void __launch_bounds__(WG_THREADS, 1)
    tc_gemm_kernel(const __grid_constant__ GemmMaps mp, const GemmArgs p) {
  using G = TcGemm<PASSES>;
  constexpr int STAGES = G::STAGES;
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int warp = warp_index(), lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * 128, n0 = blockIdx.x * 128;
  const int k_begin = blockIdx.z * p.krows, k_end = min(p.K, k_begin + p.krows);
  const int steps = k_end > k_begin ? (k_end - k_begin + 63) / 64 : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int role = warpgroup_index();
  if (role == 2) {  // the producer
    reg_dealloc<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      RingPos at;
      for (int kt = 0; kt < steps; ++kt) {
        const int k0 = k_begin + 64 * kt;
        mbar_wait(&empty[at.stage], at.phase ^ 1);
        unsigned char* sb = ring + at.stage * G::STAGE;
        uint64_t* bar = &full[at.stage];
        mbar_expect_tx(bar, G::STAGE);
        for (int pl = 0; pl < G::PLANES; ++pl) {
          unsigned char* sa = sb + pl * TC_TILE;
          if (TA == 0) {
            tma_load(sa, &mp.a[pl], k0, m0, bar);
          } else {
            tma_load(sa, &mp.a[pl], m0, k0, bar);
            tma_load(sa + TC_TILE / 2, &mp.a[pl], m0 + 64, k0, bar);
          }
          unsigned char* sbb = sb + (G::PLANES + pl) * TC_TILE;
          tma_load(sbb, &mp.b[pl], n0, k0, bar);
          tma_load(sbb + TC_TILE / 2, &mp.b[pl], n0 + 64, k0, bar);
        }
        at.advance<STAGES>();
      }
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  const int wg = role, wq = warp & 3, g = lane >> 2, t = lane & 3;
  // two accumulators, even and odd stages, added at the end: the tensor
  // cores' float32 sums lose precision with the length of a chain (over 32
  // steps of 16 a single chain leaves du about 3x further from its exact
  // value than cuBLAS's float32 product does)
  float acc[64], acc1[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = acc1[e] = 0.f;
  RingPos at;
  int prev = -1;
  auto stage = [&](float(&d)[64]) {
    mbar_wait(&full[at.stage], at.phase);
    const uint32_t sb = smem_u32(ring + at.stage * G::STAGE);
    // the group's 64 rows of A, B's 128 columns (two 64-wide blocks)
    const uint32_t a0 = sb + (TA == 0 ? wg * 64 * 128 : wg * (TC_TILE / 2));
    const uint32_t b0 = sb + G::PLANES * TC_TILE;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t a = a0 + (TA == 0 ? s * 32 : s * 2048), b = b0 + s * 2048;
      auto da = [&](uint32_t x) { return TA == 0 ? desc_k(x) : desc_mn(x, TC_TILE / 2); };
      wgmma_ss128<TA, 1>(d, da(a), desc_mn(b, TC_TILE / 2));
      if (PASSES == 3) {
        wgmma_ss128<TA, 1>(d, da(a), desc_mn(b + TC_TILE, TC_TILE / 2));
        wgmma_ss128<TA, 1>(d, da(a + TC_TILE), desc_mn(b, TC_TILE / 2));
      }
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = at.stage;
    at.advance<STAGES>();
  };
  for (int kt = 0; kt < steps; kt += 2) {
    stage(acc);
    if (kt + 1 < steps) stage(acc1);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  fence_acc(acc1);
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] += acc1[e];
  if (prev >= 0) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);
  }
  // the tile through shared memory (the ring is free once both groups are
  // done), then whole rows of it: 4 columns a lane, 16-byte accesses
  consumers_sync();
  float* Cs = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(Cs + (64 * wg + 16 * wq + g + 8 * h) * G::LDC + 8 * jj + 2 * t) =
          make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
  consumers_sync();
  float* out = p.out + blockIdx.z * p.split;
  const int c = n0 + 4 * lane;
  const bool in = c < p.N;  // N is a multiple of 16: the lane's 4 columns are in or out
  float4 cs = make_float4(0.f, 0.f, 0.f, 0.f);  // EPI_DU: the warp's rows of du, summed
  for (int rr = warp; rr < 128 && in; rr += CONSUMER_WARPS) {
    const int m = m0 + rr;
    if (m >= p.M) break;
    float4 v = *reinterpret_cast<const float4*>(Cs + rr * G::LDC + 4 * lane);
    const size_t o = (size_t)m * p.N + c;
    if (EPI == EPI_DU) {
      const float4 uu = __ldg(reinterpret_cast<const float4*>(p.u + o));
      v = make_float4(v.x * gelu_grad(uu.x), v.y * gelu_grad(uu.y), v.z * gelu_grad(uu.z),
                      v.w * gelu_grad(uu.w));
      cs = make_float4(cs.x + v.x, cs.y + v.y, cs.z + v.z, cs.w + v.w);
      uint32_t h0, l0, h1, l1;
      split2(v.x, v.y, h0, l0);
      split2(v.z, v.w, h1, l1);
      *reinterpret_cast<uint2*>(p.oh + o) = make_uint2(h0, h1);
      if (PASSES == 3) *reinterpret_cast<uint2*>(p.ol + o) = make_uint2(l0, l1);
      split2(gelu(uu.x), gelu(uu.y), h0, l0);
      split2(gelu(uu.z), gelu(uu.w), h1, l1);
      *reinterpret_cast<uint2*>(p.gh + o) = make_uint2(h0, h1);
      if (PASSES == 3) *reinterpret_cast<uint2*>(p.gl + o) = make_uint2(l0, l1);
    }
    if (EPI == EPI_ADD) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p.add + o));
      v = make_float4(v.x + a.x, v.y + a.y, v.z + a.z, v.w + a.w);
    }
    *reinterpret_cast<float4*>(out + (size_t)m * p.ldo + c) = v;
  }
  if (EPI == EPI_DU) {  // the 8 warps' sums added in order: du's column sums of the tile
    consumers_sync();    // every warp is done with Cs
    float4* red = reinterpret_cast<float4*>(Cs);
    red[warp * 32 + lane] = cs;
    consumers_sync();
    if (warp == 0 && in) {
      float4 t = red[lane];
      for (int w = 1; w < CONSUMER_WARPS; ++w) {
        const float4 x = red[w * 32 + lane];
        t = make_float4(t.x + x.x, t.y + x.y, t.z + x.z, t.w + x.w);
      }
      *reinterpret_cast<float4*>(p.colsum + (size_t)blockIdx.y * p.N + c) = t;
    }
  }
}

// One product: A's and B's maps from their planes (hi, and lo with passes
// 3): A (a_rows, a_cols) read K-major (TA 0, 128-row boxes) or MN-major (TA
// 1, 64-row boxes), B (b_rows, b_cols) MN-major; the grid from the output
// (M, N) and the splits.
template <int PASSES, int TA, int EPI>
int tc_gemm(const bf16* ah, const bf16* al, int a_rows, int a_cols, const bf16* bh,
            const bf16* bl, int b_rows, int b_cols, GemmArgs p, int splits, cudaStream_t st) {
  using G = TcGemm<PASSES>;
  static bool ready = false;
  cudaError_t e = allow_smem(tc_gemm_kernel<PASSES, TA, EPI>, G::SMEM, ready);
  if (e != cudaSuccess) return (int)e;
  GemmMaps mp;
  const int a_box = TA == 0 ? 128 : 64;
  int rc;
  if ((rc = plane_map(&mp.a[0], ah, a_rows, a_cols, a_box)) ||
      (rc = plane_map(&mp.a[1], PASSES == 3 ? al : nullptr, a_rows, a_cols, a_box)) ||
      (rc = plane_map(&mp.b[0], bh, b_rows, b_cols, 64)) ||
      (rc = plane_map(&mp.b[1], PASSES == 3 ? bl : nullptr, b_rows, b_cols, 64)))
    return rc;
  p.krows = round_up((p.K + splits - 1) / splits, 64);
  const dim3 grid((p.N + 127) / 128, (p.M + 127) / 128, splits);
  tc_gemm_kernel<PASSES, TA, EPI><<<grid, WG_THREADS, G::SMEM, st>>>(mp, p);
  return (int)cudaGetLastError();
}

// hi / lo planes of x (n values, a multiple of 4); lo null: hi only.
__global__ void split_kernel(const float* __restrict__ x, size_t n, bf16* __restrict__ hi,
                             bf16* __restrict__ lo) {
  for (size_t i = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x); i < n;
       i += 4 * (size_t)gridDim.x * blockDim.x) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(x + i));
    uint32_t h0, l0, h1, l1;
    split2(v.x, v.y, h0, l0);
    split2(v.z, v.w, h1, l1);
    *reinterpret_cast<uint2*>(hi + i) = make_uint2(h0, h1);
    if (lo != nullptr) *reinterpret_cast<uint2*>(lo + i) = make_uint2(l0, l1);
  }
}

int split_planes(const float* x, size_t n, bf16* hi, bf16* lo, cudaStream_t st) {
  const int blocks = (int)std::min<size_t>((n / 4 + NT - 1) / NT, 8 * 132);
  split_kernel<<<blocks, NT, 0, st>>>(x, n, hi, lo);
  return (int)cudaGetLastError();
}

// The weights of the split backward: W1^T (FF, D) and W2^T (D, FF) as bf16
// planes, the forward's (the lo planes only with passes 3).
struct SplitWeights {
  const bf16 *w1h, *w1l, *w2h, *w2l;
};

template <int TN, int PASSES>
int launch_bwd_split(int n, const float* g, const float* r, const float* u, const float* z,
                     const SplitWeights& w, const float* g1, const float* be1, const float* g2,
                     int M, int FF, int s_w1, int s_w2, int s_vec, float* x1, float* dz,
                     float* du, float* dr, float* dw1t, float* db1, float* dw2t, float* db2,
                     float* ln_out, float* scratch, cudaStream_t st) {
  constexpr int D = 32 * TN;
  constexpr bool LO = PASSES == 3;
  const int blocks = (M + BM - 1) / BM, tiles = (M + 127) / 128;
  const size_t MD = (size_t)M * D, MF = (size_t)M * FF;
  float* p_ln2 = scratch;                         // blocks x 2D
  float* p_ln1 = p_ln2 + (size_t)blocks * 2 * D;  // blocks x 2D
  float* p_w1 = p_ln1 + (size_t)blocks * 2 * D;   // s_w1 x FF x D
  float* p_w2 = p_w1 + (size_t)s_w1 * FF * D;     // s_w2 x D x FF
  float* p_vec = p_w2 + (size_t)s_w2 * D * FF;    // s_vec x D (db2)
  float* p_db1 = p_vec + (size_t)s_vec * D;       // row tiles x FF
  bf16* dzh = reinterpret_cast<bf16*>(p_db1 + (size_t)tiles * FF);
  bf16 *dzl = dzh + MD, *xh = dzl + MD, *xl = xh + MD, *duh = xl + MD, *dul = duh + MF,
       *hh = dul + MF, *hl = hh + MF;
  if (!LO) dzl = xl = dul = hl = nullptr;
  int rc;
#define KIT_CHECK(x) \
  if ((rc = (x)) != 0) return rc
  // phase A (_ffn_bwd_kernel_a): dz and its planes; du (and its planes,
  // gelu(u)'s planes and db1's parts); dW2^T, db2, dg2 / dbe2
  ln_bwd_kernel<TN><<<blocks, NT, 0, st>>>(g, z, g2, M, n, dz, p_ln2, dzh, dzl);
  KIT_CHECK((int)cudaGetLastError());
  GemmArgs a{M, FF, D, 0, du, FF, 0, nullptr, u, duh, dul, hh, hl, p_db1};
  KIT_CHECK((tc_gemm<PASSES, 0, EPI_DU>(dzh, dzl, M, D, w.w2h, w.w2l, D, FF, a, 1, st)));
  GemmArgs b{D, FF, M, 0, p_w2, FF, (size_t)D * FF};
  KIT_CHECK((tc_gemm<PASSES, 1, EPI_STORE>(dzh, dzl, M, D, hh, hl, M, FF, b, s_w2, st)));
  KIT_CHECK(sum_split(p_w2, s_w2, (size_t)D * FF, D * FF, dw2t, st));
  KIT_CHECK(colsum(dz, D, M, D, s_vec, p_vec, db2, st));
  KIT_CHECK(sum_split(p_ln2, blocks, 2 * D, 2 * D, ln_out, st));
  // phase B (_ffn_bwd_kernel_b): x1's planes, dW1^T, db1, dx1 and the LN1
  // backward
  if (g1 != nullptr) {
    ln_fwd_kernel<TN><<<blocks, NT, 0, st>>>(r, g1, be1, M, n, x1, xh, xl);
    KIT_CHECK((int)cudaGetLastError());
  } else {
    KIT_CHECK(split_planes(r, MD, xh, xl, st));
  }
  GemmArgs c{FF, D, M, 0, p_w1, D, (size_t)FF * D};
  KIT_CHECK((tc_gemm<PASSES, 1, EPI_STORE>(duh, dul, M, FF, xh, xl, M, D, c, s_w1, st)));
  KIT_CHECK(sum_split(p_w1, s_w1, (size_t)FF * D, FF * D, dw1t, st));
  KIT_CHECK(sum_split(p_db1, tiles, FF, FF, db1, st));
  GemmArgs d{M, D, FF, 0, dr, D, 0, dz};
  KIT_CHECK((tc_gemm<PASSES, 0, EPI_ADD>(duh, dul, M, FF, w.w1h, w.w1l, FF, D, d, 1, st)));
  if (g1 != nullptr) {
    ln_bwd_kernel<TN><<<blocks, NT, 0, st>>>(dr, r, g1, M, n, dr, p_ln1);  // in place
    KIT_CHECK((int)cudaGetLastError());
    KIT_CHECK(sum_split(p_ln1, blocks, 2 * D, 2 * D, ln_out + 2 * D, st));
  }
#undef KIT_CHECK
  return 0;
}

}  // namespace

// r (M, D) -> y (M, D); w1 (D, FF), w2 (FF, D).  g1, be1 null means no LN1;
// u (M, FF) and z (M, D), when not null, receive the training residuals.
// parts: 1 runs the row-tile build; above 1 the FF split, parts blocks
// per FF_SPLIT_ROWS-row tile over its FF_SPLIT_COLS-wide chunks (at least
// one chunk each), with parts x M x D floats of scratch.  D is 128, 256,
// 384 or 512; n <= D the model's true width (the operands zero-padded from
// n to D; see common.cuh); FF a multiple of 4.
extern "C" int kit_ffn(const void* r, int M, int D, int n, int FF, int parts, const void* w1,
                       const void* b1, const void* w2, const void* b2, const void* g1,
                       const void* be1, const void* g2, const void* be2, void* y, void* u,
                       void* z, void* scratch, void* stream) {
  auto st = (cudaStream_t)stream;
  auto f = [](const void* v) { return (const float*)v; };
  if (n > D || FF % 4 || parts < 1 ||
      (parts > 1 && (parts > (FF + FF_SPLIT_COLS - 1) / FF_SPLIT_COLS || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  const FfArgs p{f(r),  M,     n,     FF,    parts,       f(w1),     f(b1),     f(w2),
                 f(b2), f(g1), f(be1), f(g2), f(be2),     (float*)y, (float*)u, (float*)z,
                 (float*)scratch};
  return by_width(D, [&](auto tn) {
    constexpr int TN = decltype(tn)::value, DW = 32 * TN;
    return parts == 1 ? launch<TN, row_tile(DW), DW>(p, st)
                      : launch<TN, FF_SPLIT_ROWS, FF_SPLIT_COLS>(p, st);
  });
}

// The int8 forward: r (M, D) -> y (M, D).  w1q (FF, D) and w2q (D, FF) int8
// in torch's Linear layout with per-row scales w1s (FF) and w2s (D); g1,
// be1 null means no LN1; h (M, FF) is scratch.  D and n as kit_ffn takes
// them, FF a multiple of 4.
extern "C" int kit_ffn_int8(const void* r, int M, int D, int n, int FF, const void* w1q,
                            const void* w1s, const void* b1, const void* w2q, const void* w2s,
                            const void* b2, const void* g1, const void* be1, const void* g2,
                            const void* be2, void* y, void* h, void* stream) {
  auto p = [](const void* v) { return (const float*)v; };
  if (n > D || FF % 4) return (int)cudaErrorInvalidValue;
  const FFInt8 f{(const int8_t*)w1q, p(w1s), p(b1), (const int8_t*)w2q, p(w2s), p(b2), FF};
  return by_width(D, [&](auto tn) {
    return launch_int8<decltype(tn)::value>(p(r), M, n, f, p(g1), p(be1), p(g2), p(be2),
                                            (float*)y, (float*)h, (cudaStream_t)stream);
  });
}

// Gradients of kit_ffn's y given g = dL/dy (M, D), the forward's input r and
// its residuals u, z; w1t = W1^T (FF, D), w2t = W2^T (D, FF).  g1, be1 null
// means no LN1 (x1 may then be null; with LN1 it is (M, D) scratch for x1).
// Writes dz (M, D) and du (M, FF) (scratch), dr, dw1t (FF, D), db1, dw2t
// (D, FF), db2 and ln_out = [dg2 | dbe2 | dg1 | dbe1] (4 D).  scratch holds
// the partial sums: blocks * 4 D + splits * (2 FF D + FF) + ceil(M /
// resident_rows(D)) * D floats, blocks = ceil(M / 32); the weight
// gradients sum over `splits` row ranges.  D and n as kit_ffn takes them,
// FF a multiple of 4.
extern "C" int kit_ffn_bwd(const void* g, const void* r, const void* u, const void* z,
                           const void* w1t, const void* w2t, const void* g1, const void* be1,
                           int M, int D, int n, int FF, int splits, const void* g2, void* x1,
                           void* dz, void* du, void* dr, void* dw1t, void* db1, void* dw2t,
                           void* db2, void* ln_out, void* scratch, void* stream) {
  auto st = (cudaStream_t)stream;
  auto p = [](const void* v) { return (const float*)v; };
  auto o = [](void* v) { return (float*)v; };
  if (FF % 4 || FF <= 0 || n > D || splits < 1) return (int)cudaErrorInvalidValue;
  return by_width(D, [&](auto tn) {
    return launch_bwd<decltype(tn)::value>(n, p(g), p(r), p(u), p(z), p(w1t), p(w2t), p(g1),
                                           p(be1), p(g2), M, FF, splits, o(x1), o(dz), o(du),
                                           o(dr), o(dw1t), o(db1), o(dw2t), o(db2), o(ln_out),
                                           o(scratch), st);
  });
}

// The forward in mode "high" (passes 3, bf16x3) or "default" (passes 1, one
// bf16 pass): r (M, D) -> y (M, D); w1h / w1l = W1^T (FF, D) and w2h / w2l =
// W2^T (D, FF), bf16 hi / lo planes (the lo planes null with passes 1); g1,
// be1, u and z as kit_ffn takes them.  parts: 1, or the FF split over parts
// blocks per row tile (at most one per FC_TC-wide chunk) with parts x M x D
// floats of scratch.  D and n as kit_ffn takes them, FF a multiple of 16.
extern "C" int kit_ffn_tc(int passes, const void* r, int M, int D, int n, int FF, int parts,
                          const void* w1h, const void* w1l, const void* b1, const void* w2h,
                          const void* w2l, const void* b2, const void* g1, const void* be1,
                          const void* g2, const void* be2, void* y, void* u, void* z,
                          void* scratch, void* stream) {
  auto f = [](const void* v) { return (const float*)v; };
  auto h = [](const void* v) { return (const bf16*)v; };
  if (n > D || FF % 16 || FF <= 0 || !(passes == 1 || (passes == 3 && w1l && w2l)) ||
      parts < 1 || parts > (FF + FC_TC - 1) / FC_TC || (parts > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const FfArgs p{f(r),  M,     n,     FF,    parts,       nullptr,   f(b1),     nullptr,
                 f(b2), f(g1), f(be1), f(g2), f(be2),     (float*)y, (float*)u, (float*)z,
                 (float*)scratch};
  return by_width(D, [&](auto tn) {
    constexpr int TN = decltype(tn)::value;
    auto launch = passes == 3 ? launch_tc<TN, 3> : launch_tc<TN, 1>;
    return launch(p, h(w1h), h(w1l), h(w2h), h(w2l), (cudaStream_t)stream);
  });
}

// The two-phase backward of kit_ffn_tc's y in mode passes (3 "high", 1
// "default"; float32 is kit_ffn_bwd), from g = dL/dy, the forward's input r
// and its residuals u, z: w1 / w1l = W1^T (FF, D) and w2 / w2l = W2^T (D,
// FF), the forward's bf16 hi / lo planes (lo null with passes 1).  Writes
// dz (M, D) and du (M, FF) (phase A's hand-off), dr, dw1t (FF, D), db1,
// dw2t (D, FF), db2 and ln_out = [dg2 | dbe2 | dg1 | dbe1]; g1, be1 null
// means no LN1 (x1 may then be null; with LN1 it is (M, D) scratch).
// scratch: blocks * 4 D + s_w1 * FF * D + s_w2 * D * FF + s_vec * D +
// ceil(M / 128) * FF floats, blocks = ceil(M / 32), then M * (2 D + 2 FF)
// floats that hold the bf16 planes of dz, x1, du and gelu(u).  D and n as
// kit_ffn takes them, FF a multiple of 16.
extern "C" int kit_ffn_bwd_split(int passes, const void* g, const void* r, const void* u,
                                 const void* z, const void* w1, const void* w1l, const void* w2,
                                 const void* w2l, const void* g1, const void* be1, int M, int D,
                                 int n, int FF, int s_w1, int s_w2, int s_vec, const void* g2,
                                 void* x1, void* dz, void* du, void* dr, void* dw1t, void* db1,
                                 void* dw2t, void* db2, void* ln_out, void* scratch,
                                 void* stream) {
  auto p = [](const void* v) { return (const float*)v; };
  auto h = [](const void* v) { return (const bf16*)v; };
  auto o = [](void* v) { return (float*)v; };
  if (n > D || FF % 16 || FF <= 0 || s_w1 < 1 || s_w2 < 1 || s_vec < 1 ||
      !(passes == 1 || (passes == 3 && w1l && w2l)))
    return (int)cudaErrorInvalidValue;
  const SplitWeights w{h(w1), h(w1l), h(w2), h(w2l)};
  return by_width(D, [&](auto tn) {
    constexpr int TN = decltype(tn)::value;
    auto launch = passes == 3 ? launch_bwd_split<TN, 3> : launch_bwd_split<TN, 1>;
    return launch(n, p(g), p(r), p(u), p(z), w, p(g1), p(be1), p(g2), M, FF, s_w1, s_w2, s_vec,
                  o(x1), o(dz), o(du), o(dr), o(dw1t), o(db1), o(dw2t), o(db2), o(ln_out),
                  o(scratch), (cudaStream_t)stream);
  });
}
