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
#include "ffn_tc.cuh"
#include "mma_bf16.cuh"
#include "sgemm_grad.cuh"
#include "tc_gemm.cuh"

using namespace kit;

namespace {

// The FF split's build (see the note at the top): row tiles and FF chunks.
constexpr int FF_SPLIT_ROWS = 32;
constexpr int FF_SPLIT_COLS = 128;

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
