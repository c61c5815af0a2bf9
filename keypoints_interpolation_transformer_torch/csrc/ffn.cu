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
// Forward design: one block owns 32 token rows; x1 stays in shared memory,
// the FF axis is walked in D-wide chunks, each chunk's u and gelu(u) live in
// registers and a shared tile, and z accumulates in registers across the
// chunks; LN1 and LN2 run over the full row (one warp per row).  GELU uses
// erff: the rational erf of the TPU kernel exists only because Mosaic has
// no erf.
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

template <int TN>
__global__ void __launch_bounds__(NT)
ffn_kernel(const float* __restrict__ r, int M, int n, int FF, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ w2,
           const float* __restrict__ b2, const float* __restrict__ g1,
           const float* __restrict__ be1, const float* __restrict__ g2,
           const float* __restrict__ be2, float* __restrict__ y, float* __restrict__ u_out,
           float* __restrict__ z_out) {
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
    layer_norm<TN>(v, g1, be1, n);
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
        v[i][j] = c < fc ? v[i][j] + __ldg(b1 + f0 + c) : 0.f;
      }
    if (u_out != nullptr) store_rows<TN>(u_out + f0, FF, fc, row0, M, v);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) v[i][j] = gelu(v[i][j]);
    put_rows<TN>(Hs, v);
    __syncthreads();
    mma_rows<TN>(z, Hs, fc, w2 + (size_t)f0 * D, D, D, Ws);
  }
  get_rows<TN>(v, Xs);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) z[i][j] = v[i][j] + (z[i][j] + __ldg(b2 + col_of(j)));
  if (z_out != nullptr) store_rows<TN>(z_out, D, D, row0, M, z);
  layer_norm<TN>(z, g2, be2, n);
  store_rows<TN>(y, D, D, row0, M, z);
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

template <int TN>
int launch(const float* r, int M, int n, int FF, const float* w1, const float* b1,
           const float* w2, const float* b2, const float* g1, const float* be1, const float* g2,
           const float* be2, float* y, float* u, float* z, cudaStream_t st) {
  constexpr int D = 32 * TN;
  const int smem = (2 * D * LDT + BK * D) * sizeof(float);
  static bool ready = false;
  cudaError_t e = allow_smem(ffn_kernel<TN>, smem, ready);
  if (e != cudaSuccess) return (int)e;
  ffn_kernel<TN><<<(M + BM - 1) / BM, NT, smem, st>>>(r, M, n, FF, w1, b1, w2, b2, g1, be1, g2,
                                                      be2, y, u, z);
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
// D is 128, 256, 384 or 512; n <= D the model's true width (the operands
// zero-padded from n to D; see common.cuh); FF a multiple of 4.
extern "C" int kit_ffn(const void* r, int M, int D, int n, int FF, const void* w1,
                       const void* b1, const void* w2, const void* b2, const void* g1,
                       const void* be1, const void* g2, const void* be2, void* y, void* u,
                       void* z, void* stream) {
  auto st = (cudaStream_t)stream;
  auto p = [](const void* v) { return (const float*)v; };
  auto o = [](void* v) { return (float*)v; };
  if (n > D || FF % 4) return (int)cudaErrorInvalidValue;
  return by_width(D, [&](auto tn) {
    return launch<decltype(tn)::value>(p(r), M, n, FF, p(w1), p(b1), p(w2), p(b2), p(g1),
                                       p(be1), p(g2), p(be2), o(y), o(u), o(z), st);
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
