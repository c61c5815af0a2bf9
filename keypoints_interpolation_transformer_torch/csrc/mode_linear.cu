// One dense layer y = x W + b in the precision modes "high" (bf16x3) and
// "default" (one bf16 pass): the forward (kit_mode_linear) and the
// backward (kit_mode_linear_bwd).
//
// Replaces the products the JAX package leaves to XLA under those modes:
// its nn.Dense layers (the training route's pointwise chains, the per-op
// q / k / v and out-projections, the Embedding autoencoder, the serving
// chains where its pointwise kernels do not run), which run under the
// ambient jax.default_matmul_precision (train/loop.py, eval/serving.py) and
// which XLA on the TPU takes as bf16_3x ("high") or one bf16 pass
// ("default"), their transposed products in the backward at the same
// precision.  No Pallas body stands behind them.  The contract:
//   * forward: y = x_hi W_hi + x_hi W_lo + x_lo W_hi at "high", x_hi W_hi at
//     "default" (hi = bf16(v), lo = bf16(v - hi), both rounded to nearest
//     even), the float32 sum then + b;
//   * backward: dx = g W^T and dW = x^T g, each from the bf16 parts of its
//     two operands in the same mode; db = the column sums of g in float32.
//
// What bounds it on an H100: the bf16 tensor cores for a wide layer (2 M K
// N FLOP, three passes at "high"), the bytes for a narrow one (x in, y out:
// the 108-wide embeddings and head read and write about as many bytes as
// they multiply-add).
//
// Design: tc_gemm.cuh's tc_gemm_kernel (wgmma fed by TMA through an
// mbarrier ring, 128 x 128 output tiles), the pieces the pointwise chains
// and the merged layers in a mode already run:
//   forward  split W (when the caller has no planes of it yet) and x into
//            bf16 planes (split_rows_kernel: rows padded to a multiple of 16
//            columns, TMA's 16-byte row rule: 108 -> 112), then the product
//            with W's planes read MN-major and the bias in its epilogue
//            (EPI_BIAS): 2 or 3 launches.  The planes of x and W stay for
//            the backward (the autograd Function keeps them), so the
//            backward splits only g;
//   backward split g; dx = g W^T with W's planes read K-major (TB 0); dW =
//            x^T g with x's planes as an MN-major A (TA 1) over `splits`
//            row ranges, added in order (sum_split); db = the column sums
//            of g over `vsplits` row ranges (bias_sum_kernel: 16-byte loads,
//            8 warps a range), added in order (sum_parts).  No sum uses
//            atomics: a gradient has the same bits from run to run.
#include "common.cuh"
#include "grad.cuh"
#include "mma_bf16.cuh"
#include "sgemm_grad.cuh"
#include "tc_gemm.cuh"

using namespace kit;

// (A kernel in namespace kit: see attention_modes.cu.)
namespace kit {

// db's partial sums: part[z * N + c] = the sum of g's column c over the
// rows [z rows, (z + 1) rows), 4 columns a lane (16-byte loads), the 8
// warps of a block over the range's rows, then added in order of the
// warps; sum_parts adds the ranges in order.
__global__ void __launch_bounds__(NT) bias_sum_kernel(const float* __restrict__ g, int M, int N,
                                                      int rows, float* __restrict__ part) {
  __shared__ float4 red[NT / 32][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = 128 * blockIdx.x + 4 * lane, r1 = min(M, (int)(blockIdx.y + 1) * rows);
  const bool in = c < N;  // N is a multiple of 4
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = blockIdx.y * rows + warp; r < r1 && in; r += NT / 32) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(g + (size_t)r * N + c));
    s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || !in) return;
  float4 t = red[0][lane];
  for (int w = 1; w < NT / 32; ++w) {
    const float4 v = red[w][lane];
    t = make_float4(t.x + v.x, t.y + v.y, t.z + v.z, t.w + v.w);
  }
  *reinterpret_cast<float4*>(part + (size_t)blockIdx.y * N + c) = t;
}

}  // namespace kit

namespace {

#define KIT_CHECK(x) \
  if ((rc = (x)) != 0) return rc

// A width padded to the planes' row multiple: 16 bf16 (the product's k
// step, and 32 bytes).
constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

template <int PASSES>
int forward(const float* x, int M, int K, int N, const float* w, bf16* wh, bf16* wl,
            const float* b, float* y, bf16* xh, bf16* xl, cudaStream_t st) {
  const int KP = pad16(K), NP = pad16(N);
  int rc;
  if (w != nullptr) KIT_CHECK(split_rows(w, K, N, NP, wh, wl, st));
  if (M <= 0) return 0;
  KIT_CHECK(split_rows(x, M, K, KP, xh, xl, st));
  GemmArgs p{};
  p.M = M;
  p.N = N;
  p.K = KP;
  p.out = y;
  p.ldo = N;
  p.bias = b;
  // W (K, NP) planes, MN-major; rows past K read as zeros
  if (b == nullptr)
    return tc_gemm_ld<PASSES, 0, EPI_STORE, 1>(xh, xl, M, KP, KP, wh, wl, K, NP, NP, p, 1, st);
  return tc_gemm_ld<PASSES, 0, EPI_BIAS, 1>(xh, xl, M, KP, KP, wh, wl, K, NP, NP, p, 1, st);
}

template <int PASSES>
int backward(const float* g, int M, int K, int N, const bf16* xh, const bf16* xl, const bf16* wh,
             const bf16* wl, float* dx, float* dw, float* db, int splits, int vsplits, bf16* gh,
             bf16* gl, float* part, cudaStream_t st) {
  const int KP = pad16(K), NP = pad16(N);
  int rc;
  if (M <= 0) {
    if (dw != nullptr) KIT_CHECK((int)cudaMemsetAsync(dw, 0, (size_t)K * N * sizeof(float), st));
    if (db != nullptr) KIT_CHECK((int)cudaMemsetAsync(db, 0, (size_t)N * sizeof(float), st));
    return 0;
  }
  KIT_CHECK(split_rows(g, M, N, NP, gh, gl, st));
  if (dx != nullptr) {  // dx[m][k] = sum_c g[m][c] W[k][c]: W's planes K-major
    GemmArgs p{};
    p.M = M;
    p.N = K;
    p.K = NP;
    p.out = dx;
    p.ldo = K;
    KIT_CHECK((tc_gemm_ld<PASSES, 0, EPI_STORE, 0>(gh, gl, M, NP, NP, wh, wl, K, NP, NP, p, 1, st)));
  }
  if (dw != nullptr) {  // dW[k][c] = sum_m x[m][k] g[m][c], per row range of m
    GemmArgs p{};
    p.M = K;
    p.N = N;
    p.K = M;
    p.ldo = N;
    p.split = (size_t)K * N;
    p.out = splits > 1 ? part : dw;
    KIT_CHECK((tc_gemm_ld<PASSES, 1, EPI_STORE, 1>(xh, xl, M, KP, KP, gh, gl, M, NP, NP, p, splits,
                                                   st)));
    if (splits > 1) KIT_CHECK(sum_split(part, splits, p.split, K * N, dw, st));
  }
  if (db != nullptr) {
    float* vpart = part + (splits > 1 ? (size_t)splits * K * N : 0);
    bias_sum_kernel<<<dim3((N + 127) / 128, vsplits), NT, 0, st>>>(g, M, N,
                                                                  (M + vsplits - 1) / vsplits, vpart);
    KIT_CHECK((int)cudaGetLastError());
    KIT_CHECK(sum_parts(vpart, vsplits, N, db, st));
  }
  return 0;
}

#undef KIT_CHECK

bool planes_ok(int passes, const void* a, const void* b) {
  return passes == 1 || (passes == 3 && a != nullptr && b != nullptr);
}

}  // namespace

// x (M, K) -> y (M, N) = x W + b in mode passes (3 "high", 1 "default").
// w (K, N) float32 or null: split into the planes wh / wl (K, pad16(N))
// first; null: wh / wl already hold them.  b (N) or null.  xh / xl (M,
// pad16(K)) receive x's planes (the lo planes null with passes 1).  K and N
// are multiples of 4.
extern "C" int kit_mode_linear(int passes, const void* x, int M, int K, int N, const void* w,
                               void* wh, void* wl, const void* b, void* y, void* xh, void* xl,
                               void* stream) {
  if (!planes_ok(passes, wl, xl) || M < 0 || K <= 0 || N <= 0 || K % 4 || N % 4)
    return (int)cudaErrorInvalidValue;
  auto f = passes == 3 ? forward<3> : forward<1>;
  return f((const float*)x, M, K, N, (const float*)w, (bf16*)wh, (bf16*)wl, (const float*)b,
           (float*)y, (bf16*)xh, (bf16*)xl, (cudaStream_t)stream);
}

// The gradients of kit_mode_linear's y given g = dL/dy (M, N), from the
// forward's planes of x (xh / xl, (M, pad16(K))) and of W (wh / wl, (K,
// pad16(N))): dx (M, K), dW (K, N) and db (N), each null when not wanted.
// dW sums over `splits` row ranges, db over `vsplits`.  gh / gl: (M,
// pad16(N)) bf16 scratch; part: (splits > 1 ? splits K N : 0) + vsplits N
// floats.
extern "C" int kit_mode_linear_bwd(int passes, const void* g, int M, int K, int N, const void* xh,
                                   const void* xl, const void* wh, const void* wl, void* dx,
                                   void* dw, void* db, int splits, int vsplits, void* gh, void* gl,
                                   void* part, void* stream) {
  if (!planes_ok(passes, wl, xl) || !planes_ok(passes, gl, xh) || M < 0 || K <= 0 || N <= 0 ||
      K % 4 || N % 4 || splits < 1 || vsplits < 1)
    return (int)cudaErrorInvalidValue;
  auto f = passes == 3 ? backward<3> : backward<1>;
  return f((const float*)g, M, K, N, (const bf16*)xh, (const bf16*)xl, (const bf16*)wh,
           (const bf16*)wl, (float*)dx, (float*)dw, (float*)db, splits, vsplits, (bf16*)gh,
           (bf16*)gl, (float*)part, (cudaStream_t)stream);
}
