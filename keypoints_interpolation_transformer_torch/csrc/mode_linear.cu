// One dense layer y = x W + b in the precision modes "high" (bf16x3) and
// "default" (one bf16 pass): the forward (kit_mode_linear, W's planes made
// once per weight version by kit_mode_linear_weight) and the backward
// (kit_mode_linear_bwd).
//
// No Pallas body stands behind it.  It replaces the products the JAX
// package leaves to XLA under those modes: its nn.Dense layers (the
// training route's pointwise chains, the per-op q / k / v and
// out-projections, the Embedding autoencoder, the serving chains where its
// pointwise kernels do not run), which run under the ambient
// jax.default_matmul_precision (train/loop.py, eval/serving.py) and which
// XLA on the TPU takes as bf16_3x ("high") or one bf16 pass ("default"),
// their transposed products in the backward at the same precision.  It
// exists so that those products round as the TPU rounds them.  The
// contract:
//   * forward: y = x_hi W_hi + x_hi W_lo + x_lo W_hi at "high", x_hi W_hi at
//     "default" (hi = bf16(v), lo = bf16(v - hi), both rounded to nearest
//     even), the float32 sum then + b;
//   * backward: dx = g W^T and dW = x^T g, each from the bf16 parts of its
//     two operands in the same mode; db = the column sums of g in float32.
//
// What bounds it on an H100: the bytes for the model's layers (x in, y out:
// a q / k / v projection of 8192 rows, 256 -> 768, moves 34 MB for 3.2
// GFLOP of bf16 products, three passes at "high", some 0.010 ms of memory
// against 0.003-0.010 of tensor cores); and, at these sizes, the host: a
// call's device time is some 0.02 ms, as long as a few launches' host work.
//
// Design of the forward (mode_linear_kernel): ONE launch a call.  The
// tensor-core ring of tc_gemm.cuh (128 x 128 output tiles, a producer
// warpgroup issuing TMA into an mbarrier ring, two consumer warpgroups of
// 64 rows on wgmma m64n128k16, two accumulators over even and odd stages)
// with x read in float32: each 64-deep stage holds x's 128 rows as two
// 32-float TMA boxes (128-byte swizzled; TMA zero-fills past K and M, so
// 108 columns need no padding pass) beside W's planes (MN-major 64 x 64
// boxes, as tc_gemm_kernel's TB 1 reads them).  The consumers split x in
// registers: a thread loads its m64k16 A fragment's float pairs from the
// swizzled box (two wavefronts a warp, the least for 256 bytes), rounds
// them to hi / lo and feeds them to wgmma as a register A (the RS form).
// Chosen over a bf16 stage in shared memory in wgmma's layout: no second
// copy of x through shared memory (16 KB a stage at "high"), no barrier
// of the warpgroup between the split and the product, and the fragment a
// thread splits is the one it multiplies.  Each parity of stages keeps its
// own fragment registers, so a stage's products are in flight while the
// next stage is split.  The three products of a 16-deep step at "high" go
// into one accumulator in tc_gemm_kernel's order (hi hi, hi lo, lo hi).
// When the caller asks for x's planes, as ModeLinearFunction does for its
// backward, the blocks write them too (rows padded to pad16(K) columns with
// TMA's zeros, the same bits split_rows_kernel writes), each 64-deep stage
// by one column of output tiles in turn, so no column carries all the
// writes; a serving call writes nothing but y.  W's planes and
// their tensor maps are made once per weight version
// (kit_mode_linear_weight; the wrapper keeps them): a call encodes one
// map (x's) and launches one kernel.
//
// Design of the backward, redesigned for the H100: what bounded it was
// launches and host work (six a call: a split of g to scratch, dx, dW over
// row ranges, their ordered sum, db's column sums and their ordered sum).
// Now two launches and no memset:
//   1. mode_linear_kernel with W's planes read K-major (TB 0, in 32-deep
//      stages: W's 32-column boxes 64-byte swizzled, six stages in flight
//      where the forward's 64-deep ones fit three): dx = g W^T from g read
//      in float32 by TMA and split in the consumers' registers, as the
//      forward reads x; the column of tiles that owns a stage also writes
//      g's planes (M, pad16(N)) for the second launch and takes the
//      stage's column sums of g per 16 rows (a lane's two rows, then its
//      column's eight lanes in a fixed tree), db's parts;
//   2. tc_gemm_kernel (EPI_SUM): dW = x^T g from x's planes (the forward's)
//      and g's, both MN-major, over `splits` row ranges (a power of two up
//      to 8, as many as fill a wave), the ranges of an output tile one
//      thread-block cluster: each block keeps its part in shared memory and
//      adds its share of the tile's rows over every part in rank order
//      through distributed shared memory; the clusters of the first row of
//      tiles add db's parts in row order.
// No atomics and no scratch for dW's parts; every sum is in a fixed order,
// so a gradient has the same bits from run to run.
#include <string.h>

#include "common.cuh"
#include "grad.cuh"
#include "mma_bf16.cuh"
#include "mode_linear.cuh"
#include "tc_gemm.cuh"

using namespace kit;

namespace {

#define KIT_CHECK(x) \
  if ((rc = (x)) != 0) return rc

// The rows of db's column parts: 8 a 128-row tile of g (one a warp).
int colsum_rows(int M) { return (M + 127) / 128 * CONSUMER_WARPS; }

template <int PASSES>
int backward(const float* g, int M, int K, int N, const bf16* xh, const bf16* xl,
             const CUtensorMap* wmaps, float* dx, float* dw, float* db, int splits, bf16* gh,
             bf16* gl, float* part, cudaStream_t st) {
  const int KP = pad16(K), NP = pad16(N);
  int rc;
  if (M <= 0) {
    if (dw != nullptr) KIT_CHECK((int)cudaMemsetAsync(dw, 0, (size_t)K * N * sizeof(float), st));
    if (db != nullptr) KIT_CHECK((int)cudaMemsetAsync(db, 0, (size_t)N * sizeof(float), st));
    return 0;
  }
  if (dw == nullptr && db != nullptr) return (int)cudaErrorInvalidValue;
  // 1. dx = g W^T (K-major W), g's planes and db's column parts
  const LinArgs a{M, K, N, NP, nullptr, dx, K, gh, PASSES == 3 ? gl : nullptr,
                  db != nullptr ? part : nullptr};
  KIT_CHECK((linear_launch<PASSES, 0>(g, N, wmaps, a, st)));
  if (dw == nullptr) return 0;
  // 2. dW[k][c] = sum_m x[m][k] g[m][c] per row range of m, a tile's ranges
  // one cluster that adds them (and db's parts) in order
  GemmArgs p{};
  p.M = K;
  p.N = N;
  p.K = M;
  p.ldo = N;
  p.out = dw;
  p.vpart = db != nullptr ? part : nullptr;
  p.vrows = colsum_rows(M);
  p.vout = db;
  return tc_gemm_ld<PASSES, 1, EPI_SUM, 1>(xh, xl, M, KP, KP, gh, gl, M, NP, NP, p, splits, st);
}

#undef KIT_CHECK

bool planes_ok(int passes, const void* a, const void* b) {
  return passes == 1 || (passes == 3 && a != nullptr && b != nullptr);
}

// The four maps of planes wh / wl (K, pad16(N)) into maps; no launch.
int weight_maps(int passes, const void* wh, const void* wl, int K, int N, void* maps) {
  const int NP = pad16(N);
  const bf16* lo = passes == 3 ? (const bf16*)wl : nullptr;
  CUtensorMap m[4];
  int rc;
  if ((rc = plane_map(&m[0], (const bf16*)wh, K, NP, 64)) || (rc = plane_map(&m[1], lo, K, NP, 64)) ||
      (rc = kmajor_map(&m[2], (const bf16*)wh, K, NP)) || (rc = kmajor_map(&m[3], lo, K, NP)))
    return rc;
  memcpy(maps, m, sizeof(m));
  return 0;
}

}  // namespace

// W (K, N) float32 -> its planes wh / wl (K, pad16(N)) in mode passes (3
// "high", 1 "default"; wl null then), the columns past N zero, and their
// four tensor maps, encoded here once, into maps (host memory, four
// CUtensorMap; the lo ones zero at "default"): MN-major 64 x 64 boxes (what
// kit_mode_linear reads), then K-major 32 x 128 boxes (kit_mode_linear_bwd),
// kept by the caller while W is unchanged.  K and N multiples of 4.
extern "C" int kit_mode_linear_weight(int passes, const void* w, int K, int N, void* wh, void* wl,
                                      void* maps, void* stream) {
  if (!planes_ok(passes, wh, wl) || K <= 0 || N <= 0 || K % 4 || N % 4 || maps == nullptr)
    return (int)cudaErrorInvalidValue;
  const int NP = pad16(N);
  int rc = split_rows((const float*)w, K, N, NP, (bf16*)wh, passes == 3 ? (bf16*)wl : nullptr,
                      (cudaStream_t)stream);
  if (rc) return rc;
  return weight_maps(passes, wh, wl, K, N, maps);  // rows past K read as zeros
}

// x (M, K) -> y (M, N) = x W + b in mode passes (3 "high", 1 "default"):
// one launch.  wmaps: kit_mode_linear_weight's maps of W's planes (host
// memory, the first two); b (N) or null.  xh / xl (M, pad16(K)) receive
// x's planes, or are null (xl null at "default").  x and y 16-byte aligned;
// K and N multiples of 4.
extern "C" int kit_mode_linear(int passes, const void* x, int M, int K, int N, const void* wmaps,
                               const void* b, void* y, void* xh, void* xl, void* stream) {
  if (!(passes == 1 || passes == 3) || (passes == 3 && xh != nullptr && xl == nullptr) ||
      wmaps == nullptr || M < 0 || K <= 0 || N <= 0 || K % 4 || N % 4)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  CUtensorMap w[2];
  memcpy(w, wmaps, sizeof(w));
  const LinArgs p{M, N, K, pad16(K), (const float*)b, (float*)y, N, (bf16*)xh,
                  passes == 3 ? (bf16*)xl : nullptr, nullptr};
  auto f = passes == 3 ? linear_launch<3, 1> : linear_launch<1, 1>;
  return f((const float*)x, K, w, p, (cudaStream_t)stream);
}

// The gradients of kit_mode_linear's y given g = dL/dy (M, N), from the
// forward's planes of x (xh / xl, (M, pad16(K))) and W's K-major maps
// (wmaps: kit_mode_linear_weight's last two): dx (M, K), dW (K, N) and db
// (N); dx is always written; dW may be null only when db is.  dW sums over
// `splits` row ranges (1, 2, 4 or 8: a cluster).  gh / gl: (M, pad16(N))
// bf16 scratch; part: 8 ceil(M / 128) N floats (db's column parts).  Two
// launches.
extern "C" int kit_mode_linear_bwd(int passes, const void* g, int M, int K, int N, const void* xh,
                                   const void* xl, const void* wmaps, void* dx, void* dw, void* db,
                                   int splits, void* gh, void* gl, void* part, void* stream) {
  if (!planes_ok(passes, gl, xl) || xh == nullptr || gh == nullptr || wmaps == nullptr ||
      dx == nullptr || part == nullptr || M < 0 || K <= 0 || N <= 0 || K % 4 || N % 4 ||
      splits < 1 || splits > 8 || (splits & (splits - 1)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap w[2];
  memcpy(w, wmaps, sizeof(w));
  auto f = passes == 3 ? backward<3> : backward<1>;
  return f((const float*)g, M, K, N, (const bf16*)xh, (const bf16*)xl, w, (float*)dx, (float*)dw,
           (float*)db, splits, (bf16*)gh, (bf16*)gl, (float*)part, (cudaStream_t)stream);
}
