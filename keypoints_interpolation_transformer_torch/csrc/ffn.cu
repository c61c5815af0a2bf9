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
// The precision modes (mma_bf16.cuh for the arithmetic):
//   * _kernel_split ("high", bf16x3) and _kernel_single's bf16 mode
//     ("default") -> ffn_tc_kernel<TN, PASSES>: the forward above on the
//     bf16 tensor cores.  A block owns 64 token rows (32 at D > 256); x1 is
//     split into hi / lo bf16 planes in shared memory once; the FF axis is
//     walked in chunks of 4096 / rows columns, each chunk's u = x1 W1 + b1
//     (the warps 32 x 16 each), gelu(u) split into its own planes, then z +=
//     h W2 with every warp holding all rows x D / 8 columns of z in
//     registers across the chunks.  The weights arrive pre-split in torch's
//     layout (W1^T (FF, D), W2^T (D, FF): k contiguous, as the mma "col"
//     operand wants them) and stream through one 32-deep shared tile.  LN1,
//     LN2, GELU (erff), the biases and the residual stay float32; the
//     epilogue parks z in shared memory and recomputes x1 = LN1(r) per row.
//     Bound: 2.1 MFLOP per token at the flagship (times 3 for "high") over
//     989 TFLOP/s.
//   * _ffn_bwd_kernel_a / _ffn_bwd_kernel_b (the two-kernel backward) ->
//     kit_ffn_bwd_split: phase A, LN2 backward (ln_bwd), du = (dz W2^T)
//     gelu'(u) written to device memory, dW2^T = dz^T gelu(u), db2; phase
//     B, dW1^T = du^T x1, dx1 = du W1^T + dz, LN1 backward, db1; du
//     written once (N x FF float32).  The four products run through
//     tc_gemm_kernel (one 64 x 128 tile per block, operands split as they
//     are staged; the weight gradients over row ranges summed by sum_parts
//     in a fixed order, no atomics).  In float32 the same phases are the
//     backward above.
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

// The tile shapes of ffn_tc_kernel at D = 32 * TN: BR token rows per block
// (64, or 32 above D = 256, so that z stays at 64 registers a thread), the
// FF axis in chunks of FC, shared memory in bf16 elements.
template <int TN>
struct FwdTiles {
  static constexpr int D = 32 * TN;
  static constexpr int BR = D <= 256 ? 64 : 32;
  static constexpr int FC = 4096 / BR;  // 8 warps of 32 x 16 over BR x FC
  static constexpr int LDX = D + 8, LDH = FC + 8;
  static constexpr int NB = FC > D ? FC : D;  // rows of the weight tile
  static constexpr int SMEM = (2 * BR * LDX + 2 * BR * LDH + 2 * NB * LDS) * 2;  // bytes
};

// The forward in the mode's passes (see the note at the top): r (M, D) ->
// y; u (M, FF) and z (M, D) when not null.  w1h / w1l = W1^T (FF, D),
// w2h / w2l = W2^T (D, FF) as bf16 planes (the lo planes only with
// PASSES == 3); FF a multiple of 16; g1 null means no LN1.
template <int TN, int PASSES>
__global__ void __launch_bounds__(NT)
ffn_tc_kernel(const float* __restrict__ r, int M, int n, int FF, const bf16* __restrict__ w1h,
              const bf16* __restrict__ w1l, const float* __restrict__ b1,
              const bf16* __restrict__ w2h, const bf16* __restrict__ w2l,
              const float* __restrict__ b2, const float* __restrict__ g1,
              const float* __restrict__ be1, const float* __restrict__ g2,
              const float* __restrict__ be2, float* __restrict__ y, float* __restrict__ u_out,
              float* __restrict__ z_out) {
  using S = FwdTiles<TN>;
  constexpr int D = S::D, BR = S::BR, FC = S::FC, LDX = S::LDX, LDH = S::LDH;
  constexpr int MI = BR / 16, NZ = D / 64;  // z: MI x NZ tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xh = reinterpret_cast<bf16*>(smem_raw);  // BR x LDX: x1, hi
  bf16* Xl = Xh + BR * LDX;                      // ... lo
  bf16* Hh = Xl + BR * LDX;                      // BR x LDH: gelu(u) of a chunk
  bf16* Hl = Hh + BR * LDH;
  bf16* Bh = Hl + BR * LDH;  // NB x LDS: a 32-deep weight tile
  bf16* Bl = Bh + S::NB * LDS;
  const int warp = threadIdx.x >> 5, row0 = blockIdx.x * BR;

  // x1 = LN1(r) (or r), split; rows >= M are 0
  for (int rr = warp; rr < BR; rr += NT / 32) {
    const int row = row0 + rr;
    float v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) v[j] = 0.f;
    if (row < M) {
      load_row<TN>(v, r + (size_t)row * D);
      if (g1 != nullptr) row_layer_norm<TN>(v, g1, be1, n);
    }
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int c = col_of(4 * q);
      put_split4(Xh + rr * LDX + c, Xl + rr * LDX + c,
                 make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
    }
  }

  const int wm = warp / (FC / 16), wn = warp % (FC / 16);  // the warp's u tile
  float z[MI][NZ][4];
  zero_acc(z);
  for (int f0 = 0; f0 < FF; f0 += FC) {
    float u[2][2][4];
    zero_acc(u);
    for (int k0 = 0; k0 < D; k0 += TK) {
      __syncthreads();  // the weight tile is free (and, first, x1 is staged)
      SplitRows{w1h, w1l, D}.stage<FC>(Bh, Bl, f0, FF, k0, D);
      __syncthreads();
      warp_mma<2, 2, PASSES>(u, Xh + 32 * wm * LDX + k0, Xl + 32 * wm * LDX + k0, LDX,
                             Bh + 16 * wn * LDS, Bl + 16 * wn * LDS, LDS, TK);
    }
    // u += b1 (stored for training); h = gelu(u) split, 0 beyond FF
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int rr = 32 * wm + acc_row(i, e), cc = 16 * wn + acc_col(j, e), f = f0 + cc;
          float h0 = 0.f, h1 = 0.f;
          if (f < FF) {  // FF is even: f + 1 < FF too
            const float u0 = u[i][j][e] + __ldg(b1 + f), u1 = u[i][j][e + 1] + __ldg(b1 + f + 1);
            if (u_out != nullptr && row0 + rr < M)
              *reinterpret_cast<float2*>(u_out + (size_t)(row0 + rr) * FF + f) =
                  make_float2(u0, u1);
            h0 = gelu(u0);
            h1 = gelu(u1);
          }
          uint32_t hh, hl;
          split2(h0, h1, hh, hl);
          *reinterpret_cast<uint32_t*>(Hh + rr * LDH + cc) = hh;
          *reinterpret_cast<uint32_t*>(Hl + rr * LDH + cc) = hl;
        }
    // z += h W2 over the chunk
    for (int k0 = 0; k0 < FC; k0 += TK) {
      __syncthreads();  // the weight tile is free (and, first, h is written)
      SplitRows{w2h, w2l, FF}.stage<D>(Bh, Bl, 0, D, f0 + k0, FF);
      __syncthreads();
      warp_mma<MI, NZ, PASSES>(z, Hh + k0, Hl + k0, LDH, Bh + warp * (D / 8) * LDS,
                               Bl + warp * (D / 8) * LDS, LDS, TK);
    }
  }
  __syncthreads();  // x1's planes are free: z + b2 goes there
  float* Zs = reinterpret_cast<float*>(smem_raw);
  constexpr int LDZ = D + 4;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NZ; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int rr = acc_row(i, e), cc = warp * (D / 8) + acc_col(j, e);
        *reinterpret_cast<float2*>(Zs + rr * LDZ + cc) =
            make_float2(z[i][j][e] + __ldg(b2 + cc), z[i][j][e + 1] + __ldg(b2 + cc + 1));
      }
  __syncthreads();
  // z = x1 + (h W2 + b2), x1 = LN1(r) again; y = LN2(z)
  for (int rr = warp; rr < BR; rr += NT / 32) {
    const int row = row0 + rr;
    if (row >= M) continue;  // the whole warp
    float v[TN];
    load_row<TN>(v, r + (size_t)row * D);
    if (g1 != nullptr) row_layer_norm<TN>(v, g1, be1, n);
#pragma unroll
    for (int j = 0; j < TN; ++j) v[j] = v[j] + Zs[rr * LDZ + col_of(j)];
    if (z_out != nullptr) store_row<TN>(z_out + (size_t)row * D, v);
    row_layer_norm<TN>(v, g2, be2, n);
    store_row<TN>(y + (size_t)row * D, v);
  }
}

template <int TN, int PASSES>
int launch_tc(const float* r, int M, int n, int FF, const bf16* w1h, const bf16* w1l,
              const float* b1, const bf16* w2h, const bf16* w2l, const float* b2,
              const float* g1, const float* be1, const float* g2, const float* be2, float* y,
              float* u, float* z, cudaStream_t st) {
  using S = FwdTiles<TN>;
  static bool ready = false;
  cudaError_t e = allow_smem(ffn_tc_kernel<TN, PASSES>, S::SMEM, ready);
  if (e != cudaSuccess) return (int)e;
  ffn_tc_kernel<TN, PASSES><<<(M + S::BR - 1) / S::BR, NT, S::SMEM, st>>>(
      r, M, n, FF, w1h, w1l, b1, w2h, w2l, b2, g1, be1, g2, be2, y, u, z);
  return (int)cudaGetLastError();
}

// A product on the tensor cores with an epilogue: out[m][c] (m < M, c < N)
// = sum over k of A(m, k) B(c, k), then * gelu'(u[m][c]) when u is not null
// and + add[m][c] when add is not null.  Split z of the contraction (grid
// z) covers k in [z * krows, (z + 1) * krows) and writes at out + z *
// split.
struct Epilogue {
  float* out;
  int ldo;
  size_t split;
  const float* add;
  int ldadd;
  const float* u;
  int ldu;
};

constexpr int GM = 64, GN = 128;  // a block's tile: 8 warps of 32 x 32

template <class LA, class LB, int PASSES>
__global__ void __launch_bounds__(NT)
tc_gemm_kernel(const LA a, const LB b, int M, int N, int K, int krows, const Epilogue ep) {
  __shared__ __align__(16) bf16 As[2][GM * LDS];  // hi, lo
  __shared__ __align__(16) bf16 Bs[2][GN * LDS];
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int k_begin = blockIdx.z * krows, k_end = min(K, k_begin + krows);
  const int warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  float acc[2][4][4];
  zero_acc(acc);
  for (int k0 = k_begin; k0 < k_end; k0 += TK) {
    a.template stage<GM>(As[0], As[1], m0, M, k0, k_end);
    b.template stage<GN>(Bs[0], Bs[1], n0, N, k0, k_end);
    __syncthreads();
    warp_mma<2, 4, PASSES>(acc, As[0] + 32 * wm * LDS, As[1] + 32 * wm * LDS, LDS,
                           Bs[0] + 32 * wn * LDS, Bs[1] + 32 * wn * LDS, LDS, TK);
    __syncthreads();
  }
  float* out = ep.out + blockIdx.z * ep.split;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 32 * wm + acc_row(i, e), c = n0 + 32 * wn + acc_col(j, e);
        if (m >= M || c >= N) continue;
        float v = acc[i][j][e];
        if (ep.u != nullptr) v *= gelu_grad(__ldg(ep.u + (size_t)m * ep.ldu + c));
        if (ep.add != nullptr) v += __ldg(ep.add + (size_t)m * ep.ldadd + c);
        out[(size_t)m * ep.ldo + c] = v;
      }
}

template <class LA, class LB>
int tc_gemm(int passes, const LA& a, const LB& b, int M, int N, int K, int splits,
            const Epilogue& ep, cudaStream_t st) {
  const dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM, splits);
  const int krows = rows_per_split(K, splits);
  if (passes == 3)
    tc_gemm_kernel<LA, LB, 3><<<grid, NT, 0, st>>>(a, b, M, N, K, krows, ep);
  else
    tc_gemm_kernel<LA, LB, 1><<<grid, NT, 0, st>>>(a, b, M, N, K, krows, ep);
  return (int)cudaGetLastError();
}

// The split backward in the tensor-core modes (see the note at the top):
// passes 3 or 1, the weights as bf16 planes in the Flax layout: w1 (D, FF),
// w2 (FF, D) (the lo planes only for 3).
struct SplitWeights {
  const bf16 *w1h, *w1l, *w2h, *w2l;
};

template <int TN>
int launch_bwd_split(int passes, int n, const float* g, const float* r, const float* u,
                     const float* z, const SplitWeights& w, const float* g1, const float* be1,
                     const float* g2, int M, int FF, int s_w1, int s_w2, int s_vec, float* x1,
                     float* dz, float* du, float* dr, float* dw1t, float* db1, float* dw2t,
                     float* db2, float* ln_out, float* scratch, cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int blocks = (M + BM - 1) / BM;
  float* p_ln2 = scratch;                         // blocks x 2D
  float* p_ln1 = p_ln2 + (size_t)blocks * 2 * D;  // blocks x 2D
  float* p_w1 = p_ln1 + (size_t)blocks * 2 * D;   // s_w1 x FF x D
  float* p_w2 = p_w1 + (size_t)s_w1 * FF * D;     // s_w2 x D x FF
  float* p_vec = p_w2 + (size_t)s_w2 * D * FF;    // s_vec x max(D, FF)
  int rc;
#define KIT_CHECK(x) \
  if ((rc = (x)) != 0) return rc
  // phase A (_ffn_bwd_kernel_a): dz, du, dW2^T, db2, dg2 / dbe2
  ln_bwd_kernel<TN><<<blocks, NT, 0, st>>>(g, z, g2, M, n, dz, p_ln2);
  KIT_CHECK((int)cudaGetLastError());
  KIT_CHECK(tc_gemm(passes, F32Rows{dz, D}, SplitRows{w.w2h, w.w2l, D}, M, FF, D, 1,
                    Epilogue{du, FF, 0, nullptr, 0, u, FF}, st));
  KIT_CHECK(tc_gemm(passes, F32Cols<false>{dz, D}, F32Cols<true>{u, FF}, D, FF, M, s_w2,
                    Epilogue{p_w2, FF, (size_t)D * FF, nullptr, 0, nullptr, 0}, st));
  KIT_CHECK(sum_parts(p_w2, s_w2, D * FF, dw2t, st));
  KIT_CHECK(colsum(dz, D, M, D, s_vec, p_vec, db2, st));
  KIT_CHECK(sum_parts(p_ln2, blocks, 2 * D, ln_out, st));
  // phase B (_ffn_bwd_kernel_b): dW1^T, db1, dx1 and the LN1 backward
  const float* x1r = r;
  if (g1 != nullptr) {
    ln_fwd_kernel<TN><<<blocks, NT, 0, st>>>(r, g1, be1, M, n, x1);
    KIT_CHECK((int)cudaGetLastError());
    x1r = x1;
  }
  KIT_CHECK(tc_gemm(passes, F32Cols<false>{du, FF}, F32Cols<false>{x1r, D}, FF, D, M, s_w1,
                    Epilogue{p_w1, D, (size_t)FF * D, nullptr, 0, nullptr, 0}, st));
  KIT_CHECK(sum_parts(p_w1, s_w1, FF * D, dw1t, st));
  KIT_CHECK(tc_gemm(passes, F32Rows{du, FF}, SplitRows{w.w1h, w.w1l, FF}, M, D, FF, 1,
                    Epilogue{dr, D, 0, dz, D, nullptr, 0}, st));
  KIT_CHECK(colsum(du, FF, M, FF, s_vec, p_vec, db1, st));
  if (g1 != nullptr) {
    ln_bwd_kernel<TN><<<blocks, NT, 0, st>>>(dr, r, g1, M, n, dr, p_ln1);  // in place
    KIT_CHECK((int)cudaGetLastError());
    KIT_CHECK(sum_parts(p_ln1, blocks, 2 * D, ln_out + 2 * D, st));
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
// be1, u and z as kit_ffn takes them.  D and n as kit_ffn takes them, FF a
// multiple of 16.
extern "C" int kit_ffn_tc(int passes, const void* r, int M, int D, int n, int FF,
                          const void* w1h, const void* w1l, const void* b1, const void* w2h,
                          const void* w2l, const void* b2, const void* g1, const void* be1,
                          const void* g2, const void* be2, void* y, void* u, void* z,
                          void* stream) {
  auto p = [](const void* v) { return (const float*)v; };
  auto h = [](const void* v) { return (const bf16*)v; };
  auto o = [](void* v) { return (float*)v; };
  if (n > D || FF % 16 || !(passes == 1 || (passes == 3 && w1l && w2l)))
    return (int)cudaErrorInvalidValue;
  return by_width(D, [&](auto tn) {
    constexpr int TN = decltype(tn)::value;
    auto launch = passes == 3 ? launch_tc<TN, 3> : launch_tc<TN, 1>;
    return launch(p(r), M, n, FF, h(w1h), h(w1l), p(b1), h(w2h), h(w2l), p(b2), p(g1), p(be1),
                  p(g2), p(be2), o(y), o(u), o(z), (cudaStream_t)stream);
  });
}

// The two-phase backward of kit_ffn_tc's y in mode passes (3 "high", 1
// "default"; float32 is kit_ffn_bwd), from g = dL/dy, the forward's input r
// and its residuals u, z: w1 / w1l = W1 (D, FF) and w2 / w2l = W2 (FF, D),
// bf16 hi / lo planes (lo null with passes 1).  Writes dz (M, D) and du (M,
// FF) (phase A's hand-off), dr, dw1t (FF, D), db1, dw2t (D, FF), db2 and
// ln_out = [dg2 | dbe2 | dg1 | dbe1]; g1, be1 null means no LN1 (x1 may
// then be null; with LN1 it is (M, D) scratch).  scratch: blocks * 4 D +
// s_w1 * FF * D + s_w2 * D * FF + s_vec * max(D, FF) floats, blocks =
// ceil(M / 32).  D and n as kit_ffn takes them, FF a multiple of 16.
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
  if (n > D || FF % 16 || !(passes == 1 || (passes == 3 && w1l && w2l)))
    return (int)cudaErrorInvalidValue;
  const SplitWeights w{h(w1), h(w1l), h(w2), h(w2l)};
  return by_width(D, [&](auto tn) {
    return launch_bwd_split<decltype(tn)::value>(
        passes, n, p(g), p(r), p(u), p(z), w, p(g1), p(be1), p(g2), M, FF, s_w1, s_w2, s_vec,
        o(x1), o(dz), o(du), o(dr), o(dw1t), o(db1), o(dw2t), o(db2), o(ln_out), o(scratch),
        (cudaStream_t)stream);
  });
}
